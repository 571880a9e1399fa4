"""Port parity: `dsr_tpu_torch.ops.beamforming.gsc_nlms` (on CPU tensors,
the plain twin of the GSC kernel, `ops/cuda/gsc.py`) against the JAX
package's frame scan `_gsc_scan` and its Pallas kernel
(`ops/pallas/gsc.py`, interpret mode), on the inputs of
tests/test_pallas.py's GSC gate: single, batched and chunked with the
active weights threaded through `wa0`.

Tolerance: 1e-5, the JAX package's own kernel gate
(tests/test_pallas.py): Y relative to its largest magnitude, wa absolute
(|wa| is O(1)); the three versions differ only in float32 rounding order,
and the NLMS recurrence contracts, so the difference does not grow.
"""

import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import gsc_case, rel
from dsr_tpu.ops import beamforming as jbf
from dsr_tpu.ops.pallas import gsc as pgsc
from dsr_tpu_torch.ops import beamforming as bf
from dsr_tpu_torch.ops.cuda import gsc as cgsc

MU = 0.1


def _scan(X, wq, B, wa0=None):
    Y, wa = jbf._gsc_scan(jnp.transpose(X, (1, 2, 0)), wq, B, jnp.float32(MU),
                          jnp.float32(1e-6), jnp.float32(10.0), wa0)
    return np.asarray(Y), np.asarray(wa)


def test_gsc_nlms_matches_jax_scan():
    X, wq, B = gsc_case()
    Y_ref, wa_ref = _scan(X, wq, B)
    cgsc.reset_launches()
    Y, wa = bf.gsc_nlms(torch.as_tensor(X), torch.as_tensor(wq), torch.as_tensor(B), mu=MU)
    assert Y.dtype == wa.dtype == torch.complex64
    assert Y.shape == (X.shape[1], X.shape[2]) and wa.shape == B.shape[::2]
    assert rel(Y.numpy(), Y_ref) < 1e-5
    assert np.max(np.abs(wa.numpy() - wa_ref)) < 1e-5
    assert cgsc.launches["gsc"] == 0        # CPU tensors run the plain twin


def test_gsc_nlms_matches_pallas_kernel_single_and_batched():
    """The batched (U, N, T, K) form adapts each utterance with its own
    steering and blocking matrix, as the Pallas wrapper folds them into
    lanes; U = 2 here, with different inputs and steering."""
    X0, wq0, B0 = gsc_case(seed=2)
    X1, wq1, B1 = gsc_case(seed=3, M=64)
    wq1, B1 = wq1 * np.exp(0.3j).astype(np.complex64), B1[..., ::-1].copy()
    Xb, wqb, Bb = (np.stack(p) for p in ((X0, X1), (wq0, wq1), (B0, B1)))
    Y_p, wa_p = (np.asarray(a) for a in pgsc.gsc_nlms(X0, wq0, B0, mu=MU))
    Y, wa = bf.gsc_nlms(*(torch.as_tensor(a) for a in (X0, wq0, B0)), mu=MU)
    assert rel(Y.numpy(), Y_p) < 1e-5 and np.max(np.abs(wa.numpy() - wa_p)) < 1e-5
    Yb_p, wab_p = (np.asarray(a) for a in pgsc.gsc_nlms(Xb, wqb, Bb, mu=MU))
    Yb, wab = bf.gsc_nlms(*(torch.as_tensor(a) for a in (Xb, wqb, Bb)), mu=MU)
    assert Yb.shape == (2, X0.shape[1], X0.shape[2]) and wab.shape == (2, *B0.shape[::2])
    assert rel(Yb.numpy(), Yb_p) < 1e-5 and np.max(np.abs(wab.numpy() - wab_p)) < 1e-5
    assert np.array_equal(Yb[0].numpy(), Y.numpy())     # utterances do not mix


def test_gsc_nlms_wa0_threading_matches_one_pass():
    """Two halves, the second seeded with the first's final weights, equal
    one pass; and the JAX scan threaded the same way agrees."""
    X, wq, B = gsc_case(seed=4)
    T = X.shape[1]
    t = [torch.as_tensor(a) for a in (X, wq, B)]
    Y, wa = bf.gsc_nlms(*t, mu=MU)
    Y1, wa1 = bf.gsc_nlms(t[0][:, :T // 2], t[1], t[2], mu=MU)
    Y2, wa2 = bf.gsc_nlms(t[0][:, T // 2:], t[1], t[2], mu=MU, wa0=wa1)
    assert rel(torch.cat([Y1, Y2]).numpy(), Y.numpy()) < 1e-5
    assert np.max(np.abs((wa2 - wa).numpy())) < 1e-5
    _, wa1_ref = _scan(X[:, :T // 2], wq, B)
    Y2_ref, wa2_ref = _scan(X[:, T // 2:], wq, B, jnp.asarray(wa1_ref))
    assert rel(Y2.numpy(), Y2_ref) < 1e-5 and np.max(np.abs(wa2.numpy() - wa2_ref)) < 1e-5
