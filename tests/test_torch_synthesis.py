"""Port parity: the filterbank synthesis of `dsr_tpu_torch` against the JAX
package's XLA path and its Pallas kernel (interpret mode on the CPU), and
near-perfect reconstruction through the shipped prototypes.  Tolerance: 1e-5
of the largest magnitude, as in tests/test_torch_filterbank.py.
"""

import numpy as np
import pytest
import torch

from _torch_parity import filterbank_case, rel, synthesis_device_route
from dsr_tpu.ops import filterbank as jfb
from dsr_tpu.ops.pallas import filterbank as pfb
from dsr_tpu_torch.ops import filterbank as tfb

TOL = 1e-5


@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize("M", [256, 512])
def test_synthesis_matches_jax_and_reconstructs(M, ref):
    cfg, jcfg, hf, gf, delay = filterbank_case(M)
    x = np.random.default_rng(1).standard_normal((2, 20000)).astype(np.float32)
    A = np.array(jfb.analysis(x, jcfg, hf))
    jax_fn = jfb.synthesis if ref == "xla" else pfb.synthesis
    y_ref = np.asarray(jax_fn(A, jcfg, x.shape[-1], gf, delay))
    y = tfb.synthesis(torch.as_tensor(A), cfg, x.shape[-1], gf, delay)
    assert y.dtype == torch.float32
    assert rel(y.numpy(), y_ref) < TOL
    if M == 256:  # designed prototypes: near-perfect reconstruction
        err_db = 20 * np.log10(np.max(np.abs(y.numpy() - x)) / np.max(np.abs(x)))
        assert err_db < -50.0


def test_device_memory_synthesis_route_in_numpy_matches_twin():
    """The synthesis route for configs whose tile does not fit shared memory
    (`csrc/filterbank.cu`: synthesis_plan's device route, synthesis_idft_kernel
    and synthesis_ola_kernel), transcribed to NumPy (`_torch_parity`'s
    synthesis_device_route) at small sizes with large m·r: every frame's
    inverse FFT (the pack, the Stockham stages on the conjugate, the unpack)
    into rows t_lo.., then each output sample gathers m·r frames in double.
    Against the plain twin, 1e-5; at M = 64 m = 8 r = 64 (m·r = 512, D = 1)
    the twin also against the JAX package's synthesis, 1e-5."""
    from dsr_tpu.config import FilterbankConfig as JFilterbankConfig
    from dsr_tpu_torch.config import FilterbankConfig
    from dsr_tpu_torch.ops.cuda import filterbank as cfb

    rng = np.random.default_rng(3)
    for M, m, r, T, start, out_len in ((16, 4, 8, 70, 40, 50), (32, 8, 32, 300, 255, 30),
                                       (24, 2, 4, 30, 0, 100), (64, 8, 64, 700, 511, 100)):
        D, K, mr = M // r, M // 2 + 1, m * r
        A = (rng.standard_normal((2, T, K)) + 1j * rng.standard_normal((2, T, K))).astype(
            np.complex64)
        gf = rng.standard_normal(m * M).astype(np.float32)
        out_len = min(out_len, (T - 1) * D + m * M - start)
        t_lo = max(0, start // D - mr + 1)
        nrows = (start + out_len - 1) // D - t_lo + 1
        y = synthesis_device_route(A, gf, M, m, r, start, out_len, t_lo, nrows)
        ref = cfb.synthesis_plain(torch.as_tensor(A), torch.as_tensor(gf), M, r, start, out_len)
        assert rel(y, ref.numpy()) < TOL
        if (M, m, r) == (64, 8, 64):   # delay 0: the output starts at L - D
            y_jax = np.asarray(jfb.synthesis(A, JFilterbankConfig(M=M, m=m, r=r), out_len, gf, 0))
            y_port = tfb.synthesis(torch.as_tensor(A), FilterbankConfig(M=M, m=m, r=r), out_len,
                                   gf, 0)
            assert torch.equal(y_port, ref)
            assert rel(y_port.numpy(), y_jax) < TOL
