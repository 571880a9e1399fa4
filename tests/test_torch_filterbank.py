"""Port parity: the filterbank analysis of `dsr_tpu_torch` against `dsr_tpu`.

The port's plain path (what a CPU tensor runs) is held to the JAX package's
XLA path and to its Pallas kernels, which run in interpret mode on the CPU
as tests/test_pallas.py runs them.  Inputs are made with numpy from a seed
and fed to both.  Tolerance: 1e-5 of the largest magnitude, the gate of
tests/test_pallas.py; both sides compute in float32 (FFT against FFT, or
FFT against the kernels' float32 DFT matmuls), which differ at ~1e-7.
"""

import numpy as np
import pytest
import torch

from _torch_parity import filterbank_case, rel
from dsr_tpu.ops import filterbank as jfb
from dsr_tpu.ops.pallas import filterbank as pfb
from dsr_tpu_torch.ops import filterbank as tfb

TOL = 1e-5


@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize("M", [256, 512])
def test_analysis_matches_jax(M, ref):
    cfg, jcfg, hf, _, _ = filterbank_case(M)
    x = np.random.default_rng(0).standard_normal((2, 20000)).astype(np.float32)
    jax_fn = jfb.analysis if ref == "xla" else pfb.analysis
    A_ref = np.asarray(jax_fn(x, jcfg, hf))
    A = tfb.analysis(torch.as_tensor(x), cfg, hf)
    assert A.dtype == torch.complex64
    assert rel(A.numpy(), A_ref) < TOL


def test_one_dimensional_inputs_squeeze_like_jax():
    cfg, jcfg, _, _, _ = filterbank_case(256)
    x = np.random.default_rng(3).standard_normal(3000).astype(np.float32)
    A_ref = np.array(jfb.analysis(x, jcfg))
    A = tfb.analysis(torch.as_tensor(x), cfg)
    assert A.shape == A_ref.shape == (tfb.num_frames(3000, cfg), cfg.num_bins)
    y = tfb.synthesis(A, cfg, 3000)
    assert y.shape == (3000,)
    assert rel(y.numpy(), np.asarray(jfb.synthesis(A_ref, jcfg, 3000))) < TOL
