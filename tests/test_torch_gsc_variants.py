"""Port parity: the blocking matrix and the GSC variants without a kernel
(block-NLMS, RLS, maximum kurtosis) of `dsr_tpu_torch.ops.beamforming`
against `dsr_tpu.ops.beamforming`, on numpy-seeded inputs.

Tolerances (relative to the largest magnitude of the reference):
  - 1e-5 for the blocking matrix and block-NLMS (float32 rounding order);
  - maximum kurtosis after 6 ascent steps at 1e-4: each step normalises a
    gradient of fourth-order moments, so float32 rounding compounds from
    step to step (the JAX package gates its own parity at 6 steps,
    tests/test_beamforming.py);
  - RLS within 5e-3, and as close to a complex128 run of the same
    recursion as the JAX package is (within 1.5x its distance plus 1e-4):
    the conventional update (P - g zᴴP)/λ drifts from Hermitian in
    float32, so both float32 versions stand ~1e-3 from the exact one.
"""

import numpy as np
import torch

from _torch_parity import gsc_case, rel, target_and_interferer
from dsr_tpu.ops import beamforming as jbf
from dsr_tpu_torch.ops import beamforming as bf


def test_blocking_matrix_matches_jax_and_blocks_the_target():
    _, wq, B_ref = gsc_case()
    v = torch.as_tensor(wq * wq.shape[-1])
    B = bf.blocking_matrix(v)
    assert B.dtype == torch.complex64 and B.shape == B_ref.shape
    assert rel(B.numpy(), B_ref) < 1e-5
    # Bᴴv = 0 (the target is blocked) and BᴴB = I (orthonormal columns)
    assert float(torch.einsum("knm,kn->km", B.conj(), v).abs().max()) < 1e-5
    BhB = torch.einsum("knm,knl->kml", B.conj(), B)
    assert torch.allclose(BhB, torch.eye(B.shape[-1], dtype=B.dtype).expand_as(BhB), atol=1e-5)


def test_gsc_nlms_block_matches_jax():
    """T = 40 frames in blocks of 16 leave 8 tail frames, which use the
    final weights; the state is seeded through wa0."""
    X, wq, B = gsc_case(seed=5)
    wa0 = (0.05 * np.random.default_rng(6).standard_normal(B.shape[::2] + (2,))
           ).astype(np.float32).view(np.complex64)[..., 0]
    for seed in (None, wa0):
        Y_ref, wa_ref = (np.asarray(a) for a in jbf.gsc_nlms_block(X, wq, B, 0.2, wa0=seed))
        Y, wa = bf.gsc_nlms_block(*(torch.as_tensor(a) for a in (X, wq, B)), 0.2,
                                  wa0=None if seed is None else torch.as_tensor(seed))
        assert Y.shape == Y_ref.shape == (X.shape[1], X.shape[2])
        assert rel(Y.numpy(), Y_ref) < 1e-5 and rel(wa.numpy(), wa_ref) < 1e-5


def test_gsc_rls_and_maxkurt_match_jax():
    X, wq, B, _, _ = target_and_interferer(7)
    t = [torch.as_tensor(a) for a in (X, wq, B)]
    Y_ref, wa_ref = (np.asarray(a) for a in jbf.gsc_maxkurt(X, wq, B, 0.1, 6, 2.0))
    Y, wa = bf.gsc_maxkurt(*t, mu=0.1, iters=6, wa_norm_cap=2.0)
    assert rel(Y.numpy(), Y_ref) < 1e-4 and rel(wa.numpy(), wa_ref) < 1e-4

    Y_ref, wa_ref = (np.asarray(a) for a in jbf.gsc_rls(X, wq, B))
    Y, wa = bf.gsc_rls(*t)
    assert Y.dtype == torch.complex64 and Y.shape == Y_ref.shape
    assert rel(Y.numpy(), Y_ref) < 5e-3 and rel(wa.numpy(), wa_ref) < 5e-3
    Y64, wa64 = bf.gsc_rls(*(a.to(torch.complex128) for a in t))
    for port, ref, exact in ((Y, Y_ref, Y64), (wa, wa_ref, wa64)):
        assert rel(port.numpy(), exact.numpy()) <= 1.5 * rel(ref, exact.numpy()) + 1e-4
