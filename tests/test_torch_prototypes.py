"""The port's copies of the shipped filterbank prototypes: bit-equal to the
JAX package's, a clear error for a configuration with no shipped file, and
carried across unchanged by `dsr_tpu_torch.convert`.
"""

import numpy as np
import pytest
import torch

from dsr_tpu.config import FilterbankConfig as JFilterbankConfig
from dsr_tpu.ops import filterbank as jfb
from dsr_tpu_torch import convert
from dsr_tpu_torch.config import FilterbankConfig
from dsr_tpu_torch.ops import filterbank as tfb
from dsr_tpu_torch.utils import design


def test_prototypes_bit_equal_to_jax():
    shipped = sorted(design.PROTOTYPE_DIR.glob("proto-*.npz"))
    assert len(shipped) == 5
    for path in shipped:
        M, m, r, b, j = (s[1:] for s in path.stem.split("-")[1:])
        cfg = FilterbankConfig(int(M), int(m), int(r), float(b), int(j))
        jcfg = JFilterbankConfig(int(M), int(m), int(r), float(b), int(j))
        hf, gf, delay = tfb.get_prototypes(cfg)
        jhf, jgf, jdelay = jfb.get_prototypes(jcfg)
        assert hf.dtype == jhf.dtype and np.array_equal(hf, jhf)
        assert gf.dtype == jgf.dtype and np.array_equal(gf, jgf)
        assert delay == jdelay


def test_unshipped_prototype_raises():
    with pytest.raises(ValueError, match="no shipped filterbank prototype"):
        tfb.get_prototypes(FilterbankConfig(M=128, m=4, r=2))


def test_convert_prototypes():
    hf, gf, delay = design.get_prototypes(design.FilterbankConfig())
    hf_t, gf_t, d = convert.prototypes(hf, gf, np.int64(delay))
    assert hf_t.dtype == gf_t.dtype == torch.float32 and isinstance(d, int)
    assert np.array_equal(hf_t.numpy(), hf.astype(np.float32))
    assert np.array_equal(gf_t.numpy(), gf.astype(np.float32))
