"""The port's filterbank prototypes: the shipped copies bit-equal to the JAX
package's, the design of a configuration with no shipped file bit-equal to
`golden.filterbank.design_prototypes` (and run through the analysis and
synthesis against the JAX package given the same hf / gf), and carried
across unchanged by `dsr_tpu_torch.convert`.

Tolerance of the analysis and synthesis: 1e-5 of the largest magnitude of
the JAX output, as tests/test_torch_filterbank.py (float32 FFTs and sums in
another order).  The JAX package's `get_prototypes` is not called on an
unshipped configuration: it would write the design into its package.
"""

import numpy as np
import torch

from _torch_parity import rel

from dsr_tpu.config import FilterbankConfig as JFilterbankConfig
from dsr_tpu.ops import filterbank as jfb
from dsr_tpu_torch import convert
from dsr_tpu_torch.config import FilterbankConfig
from dsr_tpu_torch.ops import filterbank as tfb
from dsr_tpu_torch.utils import design
from golden import filterbank as gfb


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


def test_designed_prototypes_equal_golden():
    cfg = FilterbankConfig(M=128, m=4, r=2)
    assert not (design.PROTOTYPE_DIR / "proto-M128-m4-r2-b1-j2.npz").exists()
    for c in (cfg, FilterbankConfig(M=64, m=4, r=1, joint_iters=6)):
        ref = gfb.design_prototypes(c.M, c.m, c.r, joint_iters=c.joint_iters, rolloff=c.rolloff)
        got = tfb.get_prototypes(c)
        assert all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(got[:2], ref[:2]))
        assert got[2] == ref[2] == 0
        assert np.array_equal(design.design_prototypes(c.M, c.m, c.r, c.joint_iters,
                                                       rolloff=c.rolloff)[1], ref[1])
    hf, gf, _ = gfb.design_prototypes(128, 4, 2)
    assert design.pr_error_db(hf, gf, 128, 4, 2) == gfb.pr_error_db(hf, gf, 128, 4, 2) < -70
    jcfg = JFilterbankConfig(M=128, m=4, r=2)
    x = np.random.default_rng(3).standard_normal((2, 3000)).astype(np.float32)
    A_ref = np.array(jfb.analysis(x, jcfg, hf))
    A = tfb.analysis(torch.as_tensor(x), cfg)          # the design get_prototypes made
    assert rel(A.numpy(), A_ref) < 1e-5
    y_ref = np.asarray(jfb.synthesis(A_ref, jcfg, 3000, gf, 0))   # both given: no design
    y = tfb.synthesis(torch.as_tensor(A_ref), cfg, 3000)
    assert rel(y.numpy(), y_ref) < 1e-5
    assert 20 * np.log10(np.abs(y.numpy() - x).max() / np.abs(x).max()) < -50
    assert not (jfb._CACHE_DIR / "proto-M128-m4-r2-b1-j2.npz").exists()


def test_convert_prototypes():
    hf, gf, delay = design.get_prototypes(design.FilterbankConfig())
    hf_t, gf_t, d = convert.prototypes(hf, gf, np.int64(delay))
    assert hf_t.dtype == gf_t.dtype == torch.float32 and isinstance(d, int)
    assert np.array_equal(hf_t.numpy(), hf.astype(np.float32))
    assert np.array_equal(gf_t.numpy(), gf.astype(np.float32))
