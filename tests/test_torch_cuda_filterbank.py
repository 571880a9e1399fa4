"""The filterbank kernel wrappers on the CPU:
the fused analysis+beamform's plain twin against the Pallas fused kernel
(interpret mode), CPU tensors running the plain twins without counting a
launch, and other devices refused.  Tolerance: 1e-5 of the largest
magnitude, as in tests/test_torch_filterbank.py.
"""

import numpy as np
import pytest
import torch

from _torch_parity import SR, filterbank_case, geometry, rel
from dsr_tpu.ops import beamforming as jbf
from dsr_tpu.ops.pallas import filterbank as pfb
from dsr_tpu_torch import convert
from dsr_tpu_torch.config import FilterbankConfig
from dsr_tpu_torch.ops import filterbank as tfb
from dsr_tpu_torch.ops.cuda import filterbank as cfb


def test_fused_analysis_beamform_matches_pallas():
    """The fused analysis+beamform (plain twin of the CUDA kernel) against
    the Pallas fused kernel, MVDR weights carried across by convert."""
    N = 6
    cfg, jcfg, _, _, _ = filterbank_case(256)
    POS, taus = geometry(N, 0.10)
    Gamma = jbf.diffuse_coherence(POS, cfg.M, SR, 343.0)
    w = jbf.mvdr_weights(jbf.steering_vectors(taus, cfg.M, SR), Gamma)
    x = np.random.default_rng(7).standard_normal((N, 40960)).astype(np.float32)
    Y_ref = np.asarray(pfb.analysis_beamform(x, w, jcfg))
    Y = tfb.analysis_beamform(torch.as_tensor(x), convert.beamformer_weights(w), cfg)
    assert Y.shape == (tfb.num_frames(40960, cfg), cfg.num_bins)
    assert rel(Y.numpy(), Y_ref) < 1e-5


def test_cpu_tensors_run_plain_and_leave_launch_counters_at_zero():
    cfg = FilterbankConfig(M=64, m=4, r=2)
    x = torch.as_tensor(np.random.default_rng(4).standard_normal((3, 2000)).astype(np.float32))
    w = torch.ones((cfg.num_bins, 3), dtype=torch.complex64) / 3
    cfb.reset_launches()
    A = tfb.analysis(x, cfg)
    tfb.synthesis(A, cfg, 2000)
    Y = tfb.analysis_beamform(x, w, cfg)
    assert cfb.launches == {"analysis": 0, "analysis_beamform": 0,
                            "analysis_beamform_staged": 0, "synthesis": 0}
    assert torch.allclose(Y, A.mean(0), atol=1e-6)


def test_kernel_wrappers_refuse_other_devices():
    x = torch.zeros((2, 1000), device="meta")
    hf = torch.zeros(256, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        cfb.analysis(x, hf, 64, 4, 2, 20)
