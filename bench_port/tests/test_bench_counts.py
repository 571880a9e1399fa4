"""The roofline and step counts against shapes worked by hand."""

import pytest

from bench_port import counts, peaks


def test_rfft_flops():
    assert counts.rfft_flops(256) == 2.5 * 256 * 8


def test_analysis_beamform_64ch_8s():
    """64 ch x 128,000 samples, 1,015 frames, M = 256, m = 4: the serving
    request of PERF.md's kernel table, whose byte bound is 0.0101 ms."""
    w = counts.analysis_beamform(64, 128_000, 1015, 256, 4)
    assert w.nbytes == 4 * (64 * 128_000 + 1024) + 8 * 129 * 64 + 8 * 1015 * 129 == 33_885_624
    assert w.flops == 64 * 1015 * (2048 + 5120 + 8 * 129) == 532_672_000
    assert peaks.least_seconds(w.nbytes, w.flops) == pytest.approx(1.0115e-5, rel=1e-4)


def test_synthesis_one_channel_8s():
    assert counts.synthesis_rows(1015, 256, 4, 2, 896, 128_000) == 1007
    w = counts.synthesis(1, 1015, 256, 4, 2, 896, 128_000)
    assert w.nbytes == 8 * 1007 * 129 + 4 * 1024 + 4 * 128_000 == 1_555_320
    assert w.flops == 1007 * 5120 + 128_000 * 2 * 8 == 7_203_840


def test_select_and_expand():
    assert counts.select(1000, 100, 10) == counts.Work(12_000 + 40 + 1_200, 2_000)
    assert counts.decode_expand(1000) == counts.Work(16_000, 2_000)


def test_gmm():
    w = counts.gmm(10, 13, 128, 16)
    assert w.nbytes == 4 * 10 * 13 + 4 * 128 * 16 * 27 + 4 * 10 * 128 == 226_824
    assert w.flops == 10 * 128 * 16 * (2 * 27 + 4) == 1_187_840


def test_mfcc_and_weights():
    w = counts.mfcc_cmn(2, 10, 129, 30, 13)
    assert w.nbytes == 8 * 2 * 10 * 129 + 4 * 2 * 10 * 13
    assert w.flops == 2 * 10 * (3 * 129 + 2 * 129 * 30 + 30 + 2 * 30 * 13 + 2 * 13)
    w = counts.mvdr_weights(16, 129, 64)
    assert w.nbytes == 8 * 129 * 64 * 64 + 4 * 16 * 64 + 8 * 16 * 129 * 64
    assert w.flops == 16 * 129 * 64 * (8 * 64 + 20)


def test_work_arithmetic_and_least_time():
    a, b = counts.Work(3.35e12, 0.0), counts.Work(0.0, 67e12)
    assert peaks.least_seconds((a + b).nbytes, (a + b).flops) == pytest.approx(1.0)
    assert (2 * a).nbytes == 6.7e12 and (a * 2) == 2 * a


def _tiny_decode_run(tiny):
    """A tiny decode cell after its window and check: (run, model)."""
    import torch

    from bench_port import harness

    bench, layout = tiny
    torch.set_num_threads(2)
    cell = harness.Cell.find(bench, "tiny.batch", layout)
    model = cell.system.Model(cell.config, "cpu")
    run = cell.system.Cell(model, cell.traffic, cell.limits, 2**31 + 17)
    run.warm()
    run.serve(0.3)
    return run, model


def test_decode_work_is_the_reference_live_count(tiny):
    """The decoder's work is counted by the reference on the utterances it
    checks; on those utterances the count equals the live candidates and
    slots that the program's select sees, frame by frame."""
    import torch

    from dsr_tpu_torch.asr.decoder import topk_decoder as tk

    run, model = _tiny_decode_run(tiny)
    tg = model.tg
    assert all(v <= lim for _, v, lim in run.check())
    t = run.tally
    assert t["active_rows"] == sum(int(run.pool[b].lengths[r]) for b, r in run.sample(8))
    assert 0 < t["live_slots"] <= model.kcap * t["active_rows"] <= t["live_candidates"] * model.kcap
    seen = torch.zeros(2, dtype=torch.int64)
    inner = tk.recombine_topk
    for b, rows in _by_batch(run.sample(8)).items():
        lengths = torch.as_tensor(run.pool[b].lengths[rows])
        frame = [0]

        def wrapped(cand, dst, arcs, beam, kcap, nlat=0):
            out = inner(cand, dst, arcs, beam, kcap, nlat)
            act = (frame[0] < lengths)[:, None]
            seen[0] += ((cand > -5e29) & act).sum()
            seen[1] += ((out[0] > -5e29) & act).sum()
            frame[0] += 1
            return out

        tk.recombine_topk = wrapped
        try:
            tk.decode_batch(tg, run.ll[b][rows], run.pool[b].lengths[rows], kcap=model.kcap,
                            beam=model.beam)
        finally:
            tk.recombine_topk = inner
    assert seen.tolist() == [t["live_candidates"], t["live_slots"]]
    one, window = run.work()
    served = [b for b, _, _ in run.served]
    assert window.nbytes > one["select"].nbytes > 0 and window.flops > 0
    frames = sum(int(run.pool[b].lengths.sum()) for b in served)
    per = t["live_candidates"] / t["active_rows"]
    assert window.flops == pytest.approx(
        sum(counts.gmm(1, run.pool[0].feats.shape[-1], model.num_pdfs, 1).flops
            for _ in range(frames)) + 4 * per * frames)


def _by_batch(pairs):
    out = {}
    for b, r in pairs:
        out.setdefault(b, []).append(r)
    return out
