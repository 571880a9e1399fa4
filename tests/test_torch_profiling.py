"""The port's tracer (`dsr_tpu_torch/utils/profiling.py`) on the CPU: the
off path does nothing, spans nest and group by request, the decoder's
counters equal an independent count of what its select sees, the spans
show under `torch.profiler`, and `snapshot()` carries the kernel
wrappers' launches.  The decodes run on the port's V = 50 trigram graph
(12,225 states) at kcap 16."""

import json

import numpy as np
import pytest
import torch

from dsr_tpu_torch.asr import lvcsr
from dsr_tpu_torch.asr.am.gmm import GmmParams, loglik
from dsr_tpu_torch.asr.decoder import topk_decoder as tk
from dsr_tpu_torch.config import FilterbankConfig
from dsr_tpu_torch.ops import beamforming as bf
from dsr_tpu_torch.ops import features as ft
from dsr_tpu_torch.ops import filterbank as fb
from dsr_tpu_torch.ops.cuda import select as csel
from dsr_tpu_torch.ops.cuda import traceback as ctb
from dsr_tpu_torch.utils import profiling

KCAP, BEAM = 16, 20.0
LENGTHS = [30, 12, 25, 7]
DECODER_SPANS = {"decoder.batch": None, "decoder.frame_loop": "decoder.batch",
                 "decoder.traceback": "decoder.batch",
                 "decoder.traceback.copy": "decoder.traceback",
                 "decoder.traceback.walk": "decoder.traceback"}


@pytest.fixture(scope="module")
def tg(tmp_path_factory, monkeypatch_module):
    monkeypatch_module.setenv("DSR_TPU_TORCH_CACHE", str(tmp_path_factory.mktemp("graphs")))
    task = lvcsr.build_task(lvcsr.LvcsrConfig(vocab_size=50, n_tokens=1000, branching=3))
    return tk.build_token_graph(task.graph, device="cpu")


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def _ll(seed=0, P=120):
    rng = np.random.default_rng(seed)
    return torch.as_tensor((rng.standard_normal((len(LENGTHS), 30, P)) * 3).astype(np.float32))


def _decode(tg, ll):
    return tk.decode_batch(tg, ll, LENGTHS, kcap=KCAP, beam=BEAM)


def test_off_scope_is_the_shared_null_context():
    assert not profiling.is_recording()
    assert profiling.scope("a") is profiling.scope("b", device="cpu") is profiling._NULL
    profiling.count("nothing", 3)            # no recorder: ignored


def test_off_path_makes_no_event_sync_or_record_and_decodes_the_same(tg, monkeypatch):
    ll = _ll()
    with profiling.recording():
        on = _decode(tg, ll)

    def refuse(*a, **k):
        raise AssertionError("the off path reached the tracer")

    for target, name in ((torch.cuda, "Event"), (torch.cuda, "synchronize"),
                         (profiling, "count"), (profiling, "_Scope"),
                         (profiling._Recorder, "enter")):
        monkeypatch.setattr(target, name, refuse)
    off = _decode(tg, ll)
    assert torch.equal(off[0], on[0]) and torch.equal(off[1], on[1])
    assert off[0].dtype == on[0].dtype and off[1].dtype == on[1].dtype


def test_spans_nest_and_share_a_request_id(tg):
    with profiling.recording() as rec:
        _decode(tg, _ll(1))
        _decode(tg, _ll(2))
    spans = list(rec.spans)
    by_seq = {r.seq: r for r in spans}
    requests = {}
    for r in spans:
        parent = by_seq.get(r.parent)
        assert (parent.name if parent else None) == DECODER_SPANS[r.name]
        requests.setdefault(r.request, []).append(r.name)
        assert r.t0 <= r.t1
    assert [sorted(v) for v in requests.values()] == [sorted(DECODER_SPANS)] * 2
    snap = profiling.snapshot()["spans"]
    assert set(snap) == set(DECODER_SPANS)
    for name, s in snap.items():
        assert s["count"] == 2 and 0 < s["self_host_s"] <= s["host_s"]
    # the CPU's device time is its host time; a span with no device has none
    for name in ("decoder.frame_loop", "decoder.traceback.copy", "decoder.traceback.walk"):
        assert snap[name]["device_s"] == snap[name]["host_s"]
    for name in ("decoder.batch", "decoder.traceback"):
        assert snap[name]["device_s"] is None
    inner = snap["decoder.frame_loop"]["host_s"] + snap["decoder.traceback"]["host_s"]
    assert snap["decoder.batch"]["self_host_s"] == pytest.approx(
        snap["decoder.batch"]["host_s"] - inner)


def test_decoder_counters_equal_an_independent_count(tg, monkeypatch):
    """The same count as bench_port/tests/test_bench_counts.py makes, by
    wrapping the select the frame loop calls."""
    ll = _ll(3)
    lengths = torch.as_tensor(LENGTHS)
    seen = dict.fromkeys(("live", "slots", "rows", "written"), 0)
    frame = [0]
    inner = tk.recombine_topk

    def wrapped(cand, dst, arcs, beam, kcap, nlat=0):
        out = inner(cand, dst, arcs, beam, kcap, nlat)
        act = (frame[0] < lengths)[:, None]
        seen["live"] += int(((cand > -5e29) & act).sum())
        seen["slots"] += int(((out[0] > -5e29) & act).sum())
        seen["rows"] += int(act.sum())
        seen["written"] += cand.numel()
        frame[0] += 1
        return out

    monkeypatch.setattr(tk, "recombine_topk", wrapped)
    with profiling.recording():
        _decode(tg, ll)
    c = profiling.snapshot()["counters"]
    assert c["decoder.candidates_live"] == seen["live"] > 0
    assert c["decoder.slots_live"] == seen["slots"] > 0
    assert c["decoder.active_rows"] == seen["rows"] == sum(LENGTHS)
    assert c["decoder.candidates_written"] == seen["written"] == len(LENGTHS) * 30 * KCAP * tg.a_max
    assert c["decoder.frames"] == frame[0] == 30
    assert c["decoder.slots_live"] <= KCAP * c["decoder.active_rows"]


def test_spans_show_under_the_profiler(tg, tmp_path):
    ll = _ll(4)
    with profiling.trace(str(tmp_path)) as prof:
        with torch.profiler.record_function("outer"):
            _decode(tg, ll)
    with open(prof.trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    outer = next(e for e in events if e["name"] == "outer")
    got = {e["name"]: e for e in events if e["name"] in DECODER_SPANS}
    assert set(got) == set(DECODER_SPANS)
    for name, e in got.items():
        assert outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]
        parent = got.get(DECODER_SPANS[name])
        if parent:
            assert parent["ts"] <= e["ts"] and e["ts"] + e["dur"] <= parent["ts"] + parent["dur"]
    assert not profiling.is_recording()


def test_snapshot_holds_the_launches_and_device_counters(monkeypatch):
    monkeypatch.setitem(csel.launches, "select", 7)
    monkeypatch.setitem(ctb.launches, "traceback", 3)
    with profiling.recording():
        profiling.count("x", torch.tensor(2))
        profiling.count("x", torch.tensor([3]))
        profiling.count("y", 4)
        profiling.count("y", 1)
        with pytest.raises(RuntimeError):
            with profiling.recording():
                pass
    c = profiling.snapshot()["counters"]
    assert c["launches.select"] == 7 and c["launches.select_lattice"] == csel.launches[
        "select_lattice"]
    assert c["launches.traceback"] == 3
    assert {k: c[k] for k in ("x", "y")} == {"x": 5, "y": 5}
    assert set(profiling.launches()) >= {"select", "analysis_beamform_staged", "synthesis",
                                         "gsc", "steering", "viterbi", "traceback"}


def test_the_span_list_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 4)
    with profiling.recording() as rec:
        for _ in range(6):
            with profiling.scope("s"):
                pass
    assert len(rec.spans) == 4
    snap = profiling.snapshot()
    assert snap["spans"]["s"]["count"] == 4
    assert snap["counters"]["profiling.spans_dropped"] == 2


def test_front_end_and_scoring_spans():
    """The serving front end's calls, each its own request: MVDR weights,
    one staged fused launch a block, synthesis, MFCC, CMN and the GMM."""
    cfg = FilterbankConfig(M=256, m=4, r=2)
    N, S, G = 4, 4000, 2
    rng = np.random.default_rng(5)
    xp = fb.stage_for_beamform(rng.standard_normal((G, N, S)).astype(np.float32), device="cpu")
    taus = torch.as_tensor(rng.uniform(-1e-4, 1e-4, (G, N)), dtype=torch.float32)
    gamma = torch.eye(N, dtype=torch.complex64).expand(cfg.num_bins, N, N)
    gmm = GmmParams(torch.randn(8, 2, 13), torch.ones(8, 2, 13), torch.zeros(8, 2))
    with profiling.recording() as rec:
        v = bf.steering_vectors(taus, cfg.M, 16000.0)
        w = bf.mvdr_weights_from_inv(v, gamma)
        Y = torch.stack([fb.analysis_beamform_staged(xp, i, w[i], cfg, S) for i in range(G)])
        fb.synthesis(Y, cfg, S)
        feats = ft.cmn(ft.mfcc_from_subbands(Y, cfg.M, 16000.0))
        loglik(gmm, feats)
    snap = profiling.snapshot()["spans"]
    assert {k: s["count"] for k, s in snap.items()} == {
        "beamforming.steering_vectors": 1, "beamforming.mvdr_weights": 1,
        "filterbank.analysis_beamform": G, "filterbank.synthesis": 1, "features.mfcc": 1,
        "features.cmn": 1, "gmm.loglik": 1}
    assert all(r.parent == -1 and r.request == r.seq for r in rec.spans)
    assert all(s["device_s"] is None for s in snap.values())
