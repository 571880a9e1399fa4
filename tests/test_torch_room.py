"""Port parity: the room simulator (`dsr_tpu_torch/utils/room.py`) against
`golden/room.py`, of which it is a numpy copy: fractional delays, the
image sources, and `simulate` anechoic and in tests/test_tritrain_wer.py's
reverberant room with diffuse noise, from the same seeded generators.

Tolerance: none (the same float64 numpy operations in the same order:
equal bit for bit).
"""

import numpy as np

from dsr_tpu_torch.config import ArrayGeometry
from dsr_tpu_torch.utils import room
from golden import room as groom

POS = np.asarray(ArrayGeometry.circular(8, 0.10).positions)
SRC = np.array([0.6, 1.5, 0.3])


def test_frac_delay_and_image_sources_match_golden():
    x = np.random.default_rng(0).standard_normal(1000)
    for d in (0.0, 3.25, -1.5, 17.8):
        assert np.array_equal(room.frac_delay(x, d), groom.frac_delay(x, d))
    for order, reflect in ((0, 0.5), (2, 0.75), (3, np.array([0.9, 0.8, 0.7, 0.6, 0.5, 0.4]))):
        a = room.image_sources(np.array([2.6, 2.5, 1.5]), np.array([5.0, 4.0, 3.0]), order, reflect)
        b = groom.image_sources(np.array([2.6, 2.5, 1.5]), np.array([5.0, 4.0, 3.0]), order,
                                reflect)
        assert all(np.array_equal(u, v) for u, v in zip(a, b))
    assert np.array_equal(room.steering_delays(POS, SRC, 343.0, 16000.0),
                          groom.steering_delays(POS, SRC, 343.0, 16000.0))


def test_simulate_matches_golden():
    x = np.random.default_rng(1).standard_normal(6000)
    cases = (dict(snr_db=20.0),
             dict(snr_db=30.0, diffuse_snr_db=2.0, room_dim=np.array([5.0, 4.0, 3.0]),
                  array_center=np.array([2.0, 1.0, 1.2]), reflect=0.75, max_order=2))
    for kw in cases:
        a = room.simulate(x, POS, SRC, 16000.0, rng=np.random.default_rng(11), **kw)
        b = groom.simulate(x, POS, SRC, 16000.0, rng=np.random.default_rng(11), **kw)
        assert a.shape == (8, 6000) and np.array_equal(a, b)
