"""Port parity: the synthesis delay and its clamped start against the JAX
package's XLA path.  Tolerance: 1e-5 of the largest magnitude, as in
tests/test_torch_filterbank.py.
"""

import numpy as np
import pytest
import torch

from _torch_parity import filterbank_case, rel
from dsr_tpu.ops import filterbank as jfb
from dsr_tpu_torch.ops import filterbank as tfb


@pytest.mark.parametrize("delay", [0, 37, 100_000])
def test_synthesis_delay_and_clamped_start_match_xla(delay):
    """A delay shifts the output start; past the end of the stream the start
    is clamped, as the JAX package's dynamic slice clamps it."""
    cfg, jcfg, hf, gf, _ = filterbank_case(256)
    x = np.random.default_rng(2).standard_normal(5000).astype(np.float32)
    A = np.array(jfb.analysis(x, jcfg, hf))
    y_ref = np.asarray(jfb.synthesis(A, jcfg, x.shape[-1], gf, delay))
    y = tfb.synthesis(torch.as_tensor(A), cfg, x.shape[-1], gf, delay)
    assert rel(y.numpy(), y_ref) < 1e-5
