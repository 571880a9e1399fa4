"""Port parity: `DsrPipeline(kind="gsc")` of `dsr_tpu_torch` against
`dsr_tpu.pipeline`, through `process`, bare and with the Zelinski and
McCowan post-filters: analysis → DS quiescent weights, blocking matrix,
block-NLMS GSC → post-filter → synthesis → subband MFCC + CMN, on the CPU.

Tolerance: 1e-5 of the largest magnitude of the reference for the
waveform and 1e-4 for the features (log-mel magnifies rounding in quiet
bands, as tests/test_torch_pipeline.py allows): the GSC and the gains
repeat the JAX package's float32 arithmetic in another rounding order.
"""

import numpy as np
import pytest

from _torch_parity import rel
from dsr_tpu.config import ArrayGeometry as JGeometry
from dsr_tpu.config import BeamformerConfig as JBeamformerConfig
from dsr_tpu.config import FilterbankConfig as JFilterbankConfig
from dsr_tpu.pipeline import DsrPipeline as JDsrPipeline
from dsr_tpu_torch.config import ArrayGeometry, BeamformerConfig, FilterbankConfig
from dsr_tpu_torch.ops.cuda import gsc as cgsc
from dsr_tpu_torch.pipeline import DsrPipeline

SOURCE = np.array([0.3, 2.0, 0.0])


@pytest.mark.parametrize("postfilter", [None, "zelinski", "mccowan"])
def test_gsc_process_matches_jax(postfilter):
    bfc = dict(kind="gsc", mu=0.2)
    jpipe = JDsrPipeline(fb=JFilterbankConfig(M=64, m=4, r=2),
                         geometry=JGeometry.circular(6, 0.05),
                         beamformer=JBeamformerConfig(**bfc), postfilter=postfilter)
    pipe = DsrPipeline(fb=FilterbankConfig(M=64, m=4, r=2),
                       geometry=ArrayGeometry.circular(6, 0.05),
                       beamformer=BeamformerConfig(**bfc), postfilter=postfilter, device="cpu")
    x = np.random.default_rng(1).standard_normal((6, 6000)).astype(np.float32)
    y_ref, f_ref = (np.asarray(a) for a in jpipe.process(x, SOURCE))
    cgsc.reset_launches()
    y, feats = pipe.process(x, SOURCE)
    assert y.device.type == "cpu" and y.shape == (6000,)
    assert rel(y.numpy(), y_ref) < 1e-5
    assert rel(feats.numpy(), f_ref) < 1e-4
    assert cgsc.launches["gsc"] == 0    # the pipeline's GSC is block-NLMS, which has no kernel
