"""Port parity: the filterbank synthesis of `dsr_tpu_torch` against the JAX
package's XLA path and its Pallas kernel (interpret mode on the CPU), and
near-perfect reconstruction through the shipped prototypes.  Tolerance: 1e-5
of the largest magnitude, as in tests/test_torch_filterbank.py.
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
