"""Port parity: the cosine-modulated and PR-FFT filterbanks and the
overlap-add / overlap-save FIR filters of `dsr_tpu_torch.ops.{cmfb,prfft,
convolution}` against `dsr_tpu.ops`, on signals made with numpy from a
seed; the port's numpy design copies bit-equal to `golden`'s.

Tolerance: 1e-5 of the largest magnitude of the JAX output (float32
matmuls and FFTs whose sums run in another order).
"""

import numpy as np
import torch

from _torch_parity import rel
from dsr_tpu.ops import cmfb as jcmfb
from dsr_tpu.ops import convolution as jconv
from dsr_tpu.ops import prfft as jprfft
from dsr_tpu_torch import convert
from dsr_tpu_torch.ops import cmfb, convolution, prfft
from golden import cmfb as gcmfb
from golden import prfft as gprfft


def test_cmfb_design_and_banks_match_jax():
    g = gcmfb.design(32, m=8)
    d = cmfb.design(32, m=8)
    for name in ("ha", "hs", "M", "delay", "gain"):
        assert np.array_equal(getattr(d, name), getattr(g, name)), name
    c = convert.cmfb_design(g)
    assert isinstance(c, cmfb.CmfbDesign) and np.array_equal(c.ha, g.ha) and c.delay == g.delay
    x = np.random.default_rng(1).standard_normal((3, 4000)).astype(np.float32)
    U_ref = np.array(jcmfb.analysis(x, g))
    U = cmfb.analysis(torch.as_tensor(x), c)
    assert U.shape == U_ref.shape
    assert rel(U.numpy(), U_ref) < 1e-5
    y_ref = np.asarray(jcmfb.synthesis(U_ref, g, 4000))
    y = cmfb.synthesis(torch.as_tensor(U_ref), c, 4000)
    assert rel(y.numpy(), y_ref) < 1e-5
    L = g.ha.shape[1]
    seg = slice(2 * L, 4000 - 2 * L)
    err = np.abs(cmfb.synthesis(U, d, 4000).numpy()[:, seg] - x[:, seg]).max()
    assert 20 * np.log10(err / np.abs(x).max()) < -40.0


def test_prfft_matches_jax():
    for M, D in ((256, 128), (256, 64), (128, 128), (127, 127)):
        assert np.array_equal(prfft.design_cola_window(M, D), gprfft.design_cola_window(M, D))
        assert prfft.num_frames(4000, M, D) == gprfft.num_frames(4000, M, D)
        rng = np.random.default_rng(M + D)
        x = rng.standard_normal((2, 4000)).astype(np.float32)
        A_ref = np.array(jprfft.analysis(x, M, D))
        A = prfft.analysis(torch.as_tensor(x), M, D)
        assert rel(A.numpy(), A_ref) < 1e-5
        y = prfft.synthesis(A, M, D, 4000)
        assert rel(y.numpy(), np.asarray(jprfft.synthesis(A_ref, M, D, 4000))) < 1e-5
        assert 20 * np.log10(np.abs(y.numpy() - x).max() / np.abs(x).max()) < -100.0
        # random spectra: DC and Nyquist have imaginary parts, which both ignore
        R = (rng.standard_normal(A_ref.shape) + 1j * rng.standard_normal(A_ref.shape)).astype(
            np.complex64)
        assert rel(prfft.synthesis(torch.as_tensor(R), M, D, 4000).numpy(),
                   np.asarray(jprfft.synthesis(R, M, D, 4000))) < 1e-5, (M, D)


def test_overlap_add_and_save_match_jax():
    rng = np.random.default_rng(0)
    for shape, L, block in (((3, 5000), 101, 256), ((2, 2, 3000), 33, 1000),
                            ((2, 9000), 4096, 4096)):
        x = rng.standard_normal(shape).astype(np.float32)
        h = (rng.standard_normal(L) * np.exp(-np.arange(L) / (L / 6))).astype(np.float32)
        for name in ("overlap_add", "overlap_save"):
            ref = np.asarray(getattr(jconv, name)(x, h, block))
            got = getattr(convolution, name)(torch.as_tensor(x), torch.as_tensor(h), block)
            assert got.shape == ref.shape and rel(got.numpy(), ref) < 1e-5, (name, shape)
    direct = np.convolve(x[0].astype(np.float64), h.astype(np.float64))[:9000]
    assert rel(convolution.overlap_add(torch.as_tensor(x), h, 4096)[0].numpy(), direct) < 1e-5
