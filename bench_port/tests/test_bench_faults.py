"""A run with the timed path broken underneath comes out not correct:
each fault the cells can have, planted in the port at a tiny size on the
CPU (the harness's look for a card is skipped, the rest of the run is
whole).  The cells run on one card and their front end keeps no state
between blocks, so neither the missing exchange between chips nor (for
the front end) a step that returns its state unchanged applies."""

import pytest
import torch

from conftest import run_tiny


def test_sound_runs_are_correct(tiny):
    bench, layout = tiny
    for w in ("tiny.batch", "tiny.fe"):
        assert run_tiny(bench, layout, w)[0]["correct"] is True


def _frozen_tokens(monkeypatch):
    """Every frame step returns its tokens unchanged."""
    from dsr_tpu_torch.asr.decoder import topk_decoder as tk

    inner = tk.token_pass

    def frozen(expand, ll, lengths, states, scores, beam, kcap, nlat=0):
        def same(st, sc, ll_t):
            return sc, st, torch.full_like(st, -1)
        return inner(same, ll, lengths, states, scores, beam, kcap, nlat)

    monkeypatch.setattr(tk, "token_pass", frozen)


def _half_batch(monkeypatch):
    """Only the first half of each batch is decoded; the rest come back
    empty."""
    from dsr_tpu_torch.asr.decoder import topk_decoder as tk

    inner = tk.decode_batch

    def half(graph, ll, lengths, kcap=256, beam=1e9, return_spill=False):
        U, T = ll.shape[:2]
        h = U // 2
        o, s = inner(graph, ll[:h], lengths[:h], kcap=kcap, beam=beam)
        olabs = torch.zeros((U, T), dtype=o.dtype)
        scores = torch.zeros(U, dtype=s.dtype)
        olabs[:h], scores[:h] = o, s
        return olabs, scores

    monkeypatch.setattr(tk, "decode_batch", half)


def _altered_token(monkeypatch):
    """The select's best token of every utterance names the next arc id
    than the one that reached it (an off-by-one where the token is
    produced)."""
    from dsr_tpu_torch.asr.decoder import topk_decoder as tk

    inner = tk.recombine_topk

    def altered(cand, dst, arcs, beam, kcap, nlat=0):
        out = list(inner(cand, dst, arcs, beam, kcap, nlat))
        out[2] = out[2].clone()
        out[2][:, 0] += 1
        return tuple(out)

    monkeypatch.setattr(tk, "recombine_topk", altered)


def _half_blocks(monkeypatch):
    """The fused kernel leaves out every odd block of a group (zeros)."""
    from dsr_tpu_torch.ops import filterbank as fb

    inner = fb.analysis_beamform_staged

    def half(xp, idx, w, cfg, num_samples, hf=None):
        y = inner(xp, idx, w, cfg, num_samples, hf)
        return torch.zeros_like(y) if int(idx) % 2 else y

    monkeypatch.setattr(fb, "analysis_beamform_staged", half)


def _altered_sample(monkeypatch):
    """The synthesis alters one output sample of each block by a hundredth
    of the block's peak."""
    from dsr_tpu_torch.ops import filterbank as fb

    inner = fb.synthesis

    def altered(A, cfg, out_len, gf=None, delay=None):
        y = inner(A, cfg, out_len, gf, delay).clone()
        y[..., 100] += 0.01 * y.abs().amax(-1)
        return y

    monkeypatch.setattr(fb, "synthesis", altered)


@pytest.mark.parametrize("workload, plant", [
    ("tiny.batch", _frozen_tokens), ("tiny.batch", _half_batch),
    ("tiny.batch", _altered_token), ("tiny.fe", _half_blocks), ("tiny.fe", _altered_sample)])
def test_fault_is_not_correct(tiny, monkeypatch, workload, plant):
    bench, layout = tiny
    plant(monkeypatch)
    result, checks, _ = run_tiny(bench, layout, workload)
    assert result["correct"] is False, checks
