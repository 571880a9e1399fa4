"""The port's modal beamformer design (`dsr_tpu_torch.ops.modal`, numpy with
no scipy): its spherical harmonics and spherical Bessel functions against
`scipy.special` (imported here only), its weights against `golden.modal`'s
and `dsr_tpu.ops.modal`'s, and tests/test_convolution_modal.py's steering
gate.

Tolerances: 1e-12 absolute for Y_n^m and j_n (float64 recurrences and
series; |Y| <= 1.1 and |j_n| <= 1 here); 1e-10 absolute for the weights
(a pseudo-inverse of the same matrix up to those errors); the subband
weights within 1e-6 of their largest magnitude (both rounded to complex64).
"""

import numpy as np
from scipy.special import sph_harm_y, spherical_jn

from _torch_parity import rel
from dsr_tpu.ops import modal as jmodal
from dsr_tpu_torch.ops import modal
from golden import modal as gmodal

LOOK = np.array([np.pi / 2, 0.0])


def test_sph_harm_and_spherical_jn_match_scipy():
    rng = np.random.default_rng(0)
    th = np.concatenate([rng.uniform(0, np.pi, 60), [0.0, np.pi, np.pi / 2]])
    ph = np.concatenate([rng.uniform(0, 2 * np.pi, 60), [0.0, 1.0, 2.0]])
    Y = modal.sh_matrix(6, th, ph)
    assert Y.shape == (63, 49)
    col = 0
    for n in range(7):
        for m in range(-n, n + 1):
            assert np.abs(Y[:, col] - sph_harm_y(n, m, th, ph)).max() < 1e-12, (n, m)
            col += 1
    ka = np.concatenate([np.logspace(-4, np.log10(20.0), 300), np.arange(0.5, 20.5, 0.5)])
    for n in range(7):
        assert np.abs(modal.spherical_jn(n, ka) - spherical_jn(n, ka)).max() < 1e-12, n
    # the series below ka = n + 1, where the upward recurrence loses j_n
    assert abs(modal.spherical_jn(3, 0.05)[0] / spherical_jn(3, 0.05) - 1) < 1e-12


def test_modal_weights_match_golden():
    dirs = modal.sphere_mic_dirs(32)
    assert np.array_equal(dirs, jmodal.sphere_mic_dirs(32))
    for order, ka in ((3, 0.05), (3, 0.5), (3, 2.0), (2, 6.1), (4, 3.3)):
        for reg in (1e-2, 1e-3):
            w = modal.modal_weights(order, ka, dirs, LOOK, reg)
            assert np.abs(w - gmodal.modal_weights(order, ka, dirs, LOOK, reg)).max() < 1e-10
        src = np.array([1.1, 2.4])
        assert np.abs(modal.plane_wave_pressure(order, ka, dirs, src)
                      - gmodal.plane_wave_pressure(order, ka, dirs, src)).max() < 1e-10


def test_modal_weights_subband_match_jax():
    dirs = modal.sphere_mic_dirs(16)
    W = modal.modal_weights_subband(2, 0.05, 64, 16000.0, dirs, np.array([1.0, 0.5]))
    W_ref = jmodal.modal_weights_subband(2, 0.05, 64, 16000.0, dirs, np.array([1.0, 0.5]))
    assert W.shape == (33, 16) and W.dtype == np.complex64
    assert rel(W, W_ref) < 1e-6


def test_modal_beamformer_steers():
    """tests/test_convolution_modal.py's gate on the port's functions: a plane
    wave from the look direction keeps > 0.5 gain, off-look ones < 0.6 of it."""
    dirs = modal.sphere_mic_dirs(32)
    w = modal.modal_weights(3, 2.0, dirs, LOOK, reg=1e-3)
    gain_on = abs(np.conj(w) @ modal.plane_wave_pressure(3, 2.0, dirs, LOOK))
    gains_off = [abs(np.conj(w) @ modal.plane_wave_pressure(3, 2.0, dirs,
                                                            np.array([np.pi / 2, az])))
                 for az in (1.2, 2.2, 3.0)]
    assert gain_on > 0.5 and max(gains_off) < 0.6 * gain_on
