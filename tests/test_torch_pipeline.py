"""Port parity end to end: `dsr_tpu_torch.pipeline.DsrPipeline.process`
against `dsr_tpu.pipeline` (DS and MVDR; the GSC in
tests/test_torch_pipeline_gsc.py), and the options it refuses.

Tolerances, relative to the largest magnitude of the reference: 1e-5 for
the DS waveform (filterbank and beamform rounding only); 1e-4 for what the
MVDR weights feed (their solve is ill-conditioned at the low bins, see
tests/test_torch_beamforming.py) and for features (log-mel magnifies
rounding in quiet bands).
"""

import numpy as np
import pytest

from _torch_parity import rel
from dsr_tpu.config import ArrayGeometry as JGeometry
from dsr_tpu.config import BeamformerConfig as JBeamformerConfig
from dsr_tpu.config import FilterbankConfig as JFilterbankConfig
from dsr_tpu.pipeline import DsrPipeline as JDsrPipeline
from dsr_tpu_torch.config import ArrayGeometry, BeamformerConfig, FilterbankConfig
from dsr_tpu_torch.ops.cuda import filterbank as cfb
from dsr_tpu_torch.pipeline import DsrPipeline

SOURCE = np.array([0.3, 2.0, 0.0])


@pytest.mark.parametrize("kind,geometry,wave_tol", [
    ("ds", ("linear", 8, 0.04), 1e-5),
    ("mvdr", ("circular", 8, 0.10), 1e-4),
])
def test_process_matches_jax(kind, geometry, wave_tol):
    shape, n, size = geometry
    jpipe = JDsrPipeline(fb=JFilterbankConfig(M=256, m=4, r=2),
                         geometry=getattr(JGeometry, shape)(n, size),
                         beamformer=JBeamformerConfig(kind=kind))
    pipe = DsrPipeline(fb=FilterbankConfig(M=256, m=4, r=2),
                       geometry=getattr(ArrayGeometry, shape)(n, size),
                       beamformer=BeamformerConfig(kind=kind), device="cpu")
    x = np.random.default_rng(0).standard_normal((n, 8000)).astype(np.float32)
    y_ref, f_ref = (np.asarray(a) for a in jpipe.process(x, SOURCE))
    cfb.reset_launches()
    y, feats = pipe.process(x, SOURCE)
    assert y.device.type == "cpu" and y.shape == (8000,)
    assert rel(y.numpy(), y_ref) < wave_tol
    assert rel(feats.numpy(), f_ref) < 1e-4
    assert sum(cfb.launches.values()) == 0


@pytest.mark.parametrize("kwargs,match", [
    (dict(beamformer=BeamformerConfig(kind="lcmv")), "unknown beamformer kind"),
    (dict(postfilter="wiener"), "unknown postfilter"),
    (dict(beamformer=BeamformerConfig(kind="gsc"), postfilter="lefkimmiatis"),
     "unknown postfilter"),
])
def test_unported_options_raise(kwargs, match):
    """Options that neither package's pipeline carries are refused (the
    GSC, the post-filters and WPE, once refused here, are ported)."""
    with pytest.raises(ValueError, match=match):
        DsrPipeline(device="cpu", **kwargs)
