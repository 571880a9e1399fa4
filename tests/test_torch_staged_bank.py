"""The staged buffer bank of the fused analysis + beamform
(`ops/filterbank.stage_for_beamform` / `analysis_beamform_staged`) on the
CPU: every buffer, by int and by 0-d tensor index, against the JAX
package's `apply_weights(analysis(x))` at tests/test_pallas.py's staged-bank
shapes (4 ch x 20,000 samples, 3 buffers, DS weights), tol 1e-5 of the
largest magnitude; against the port's unstaged call bit for bit; a CPU call
counts no launch; and a bad index is refused.  The CUDA kernel reads a
device index itself and is held to the unstaged kernel bit for bit by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from _torch_parity import SR, filterbank_case, geometry, rel
from dsr_tpu.ops import beamforming as jbf
from dsr_tpu.ops import filterbank as jfb
from dsr_tpu_torch import convert
from dsr_tpu_torch.ops import filterbank as tfb
from dsr_tpu_torch.ops.cuda import filterbank as cfb


def test_staged_bank_matches_jax_and_the_unstaged_call():
    N, S = 4, 20000
    cfg, jcfg, _, _, _ = filterbank_case(256)
    POS, taus = geometry(N, 0.08)
    w = jbf.ds_weights(jbf.steering_vectors(taus, cfg.M, SR))
    xs = np.random.default_rng(8).standard_normal((3, N, S)).astype(np.float32)
    xp = tfb.stage_for_beamform(xs, device="cpu")
    assert xp.shape == (3, N, S) and xp.dtype == torch.float32 and xp.is_contiguous()
    wt = convert.beamformer_weights(w)
    cfb.reset_launches()
    for i in range(3):
        ref = np.asarray(jbf.apply_weights(jfb.analysis(xs[i], jcfg), w))
        by_int = tfb.analysis_beamform_staged(xp, i, wt, cfg, S)
        by_tensor = tfb.analysis_beamform_staged(xp, torch.tensor(i, dtype=torch.int32), wt,
                                                 cfg, S)
        assert by_int.shape == ref.shape
        assert rel(by_int.numpy(), ref) < 1e-5
        unstaged = tfb.analysis_beamform(torch.as_tensor(xs[i]), wt, cfg)
        assert torch.equal(by_int, unstaged) and torch.equal(by_tensor, unstaged)
    assert cfb.launches["analysis_beamform_staged"] == 0
    with pytest.raises(IndexError):
        tfb.analysis_beamform_staged(xp, 3, wt, cfg, S)
    with pytest.raises(ValueError, match="0-d int32"):
        tfb.analysis_beamform_staged(xp, torch.tensor([1]), wt, cfg, S)
