"""The select kernel's plain twin (`dsr_tpu_torch.ops.cuda.select`) against
the JAX decoders' sort path (`ref_select`, the NumPy transcription in
tests/test_pallas_select.py), and the wrapper's device dispatch.  The
twin against the Pallas kernel, and the CUDA kernel's block routine in
NumPy, are in tests/test_torch_select_kernel.py; the kernel itself is held
to the twin on the card by chip_smoke.py.

Tolerance: none.  The function only moves its input values (sort,
recombine, prune, select), so outputs must be equal bit for bit.
"""

import numpy as np
import pytest
import torch

from _torch_parity import NEG, ref_select, select_case
from dsr_tpu_torch.ops.cuda import select as sel

def _check_twin(c, d, a, beams, kcap):
    s, dd, aa = sel.recombine_topk(torch.as_tensor(c), torch.as_tensor(d), torch.as_tensor(a),
                                   torch.as_tensor(np.asarray(beams, np.float32)), kcap)
    for u in range(c.shape[0]):
        rs, rd, ra = ref_select(c[u], d[u], a[u], np.float32(beams[u]), kcap)
        alive = rs > NEG / 2
        k = len(rs)
        assert np.array_equal(s[u, :k].numpy().view(np.uint32), rs.view(np.uint32))
        assert np.array_equal(dd[u, :k].numpy(), np.where(alive, rd, 0))
        assert np.array_equal(aa[u, :k].numpy(), np.where(alive, ra, -1))
        assert (s[u, k:] == NEG).all() and (dd[u, k:] == 0).all() and (aa[u, k:] == -1).all()


def test_twin_matches_sort_path_at_the_decoders_pool_shapes():
    """(kcap+eg)·a0 = 2,304 and 4,608 (split), kcap·a_max = 12,032 and
    134,656 (dense), with the per-utterance beams 40 and 1e9."""
    for N, kcap, U in ((2304, 256, 4), (4608, 512, 2), (12032, 256, 2), (134656, 512, 2)):
        c, d, a = select_case(N, U, N, N // 3)
        _check_twin(c, d, a, [40.0, 1e9] * (U // 2), kcap)


def test_twin_matches_sort_path_on_adversarial_cases():
    """Duplicate-heavy pools, NEG padding, fewer live destinations than
    kcap, pools smaller than kcap, binding and per-utterance beams, and
    signed-zero ties."""
    for seed, (U, N, ndst, kcap, beams) in enumerate([
            (3, 2000, 400, 128, [1e9, 2.0, 0.5]),
            (2, 600, 10000, 128, [1e9, 6.0]),
            (2, 3000, 20, 128, [1e9, 1e9]),
            (2, 100, 1000, 256, [1e9, 3.0]),
            (2, 512, 300, 256, [1e9, 1e9])]):
        c, d, a = select_case(seed, U, N, ndst, grid=1.0)
        c[0, ::7] = -0.0
        c[0, 3::7] = 0.0
        _check_twin(c, d, a, beams, kcap)


def test_wrapper_runs_the_twin_on_cpu_and_refuses_other_devices():
    c, d, a = (torch.as_tensor(x) for x in select_case(3, 2, 500, 100))
    sel.reset_launches()
    out = sel.recombine_topk(c, d, a, 10.0, 64)
    ref = sel.recombine_topk_plain(c, d, a, torch.full((2,), 10.0), 64)
    assert all(torch.equal(x, y) for x, y in zip(out, ref))
    assert sel.launches == {"select": 0, "select_lattice": 0}
    with pytest.raises(ValueError, match="CUDA device or all on"):
        sel.recombine_topk(c.to("meta"), d.to("meta"), a.to("meta"), 10.0, 64)
    with pytest.raises(ValueError, match="N >= 1"):
        sel.recombine_topk(c[:, :0], d[:, :0], a[:, :0], 10.0, 64)
