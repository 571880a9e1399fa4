"""The LVCSR decode cells: batches of utterances through the
port's GMM scoring and batched top-K decode, in a closed loop.

A request is one utterance.  A batch of `utterances_per_batch` is
dispatched when the previous batch's words are on the host: its
log-likelihoods (`asr/am/gmm.loglik`), then `topk_decoder.decode_batch`,
whose traceback returns the words as CPU tensors.  Every utterance of a
batch completes with it.  The batches cycle through the pool that the
mix's generator made from the seed.

The program gets the packed graph (the configuration's model, built by
the port's graph compiler once per checkout and refused unless its arcs'
fingerprint is the one the configuration states), the GMM's parameters
(made here from the configuration) and the features (made here from the
seed).  The reference (`reference/lvcsr_decode.py`) reads the same packed
arcs, parameters and features and works out the rest itself.

The decoder's work for the rooflines and `step_mfu` depends on how many
tokens the beam keeps.  It is counted by the reference on the utterances
it checks (live candidates and slots a frame an utterance) and scaled to
each batch by its utterances' frames: what these inputs need, whatever
the program does with them.
"""

from __future__ import annotations

import time

import numpy as np
import torch

import importlib

from bench_port import counts
from bench_port.reference import lvcsr_decode as ref
from bench_port.trace import span


class Model:
    """What every seed shares: the task's graph, the decoder's tables and
    the acoustic model."""

    def __init__(self, config: dict, device):
        from dsr_tpu_torch.asr import lvcsr
        from dsr_tpu_torch.asr.am.gmm import GmmParams
        from dsr_tpu_torch.asr.decoder import topk_decoder as tk

        self.config, self.device = config, torch.device(device)
        self.task = lvcsr.build_task(lvcsr.LvcsrConfig(**config["lvcsr"]))
        g = self.task.graph
        a_max = int(np.bincount(g.src).max())
        got = {"num_states": g.num_states, "num_arcs": g.num_arcs, "a_max": a_max,
               "arcs_sha256": ref.graph_digest(g.src, g.pdf, g.olabel, g.weight, g.dst,
                                               g.start, g.final_weight, g.num_states)}
        want = config.get("expect", got)
        if got != want:
            raise RuntimeError(f"the task's graph is {got}, the configuration states {want}")
        self.tg = tk.build_token_graph(g, device=self.device)
        am = config["am"]
        P = self.task.num_pdfs
        self.num_pdfs = P
        self.means = (am["scale"] * torch.eye(P, device=self.device))[:, None, :]
        self.variances = torch.full((P, 1, P), am["var"], device=self.device)
        self.logw = torch.zeros((P, 1), device=self.device)
        self.params = GmmParams(self.means, self.variances, self.logw).to(self.device)
        self.kcap, self.beam = config["decoder"]["kcap"], config["decoder"]["beam"]
        self.fps = config["frames_per_s"]

    def release(self):
        self.tg = self.params = None


class Cell:
    def __init__(self, model: Model, traffic: dict, limits: dict, seed: int,
                 spans: bool = False):
        self.model, self.limits, self.seed, self.spans = model, limits, seed, spans
        gen = importlib.import_module(f"bench_port.generators.{traffic['generator']}")
        self.pool = gen.make_pool(model.config["lvcsr"], traffic, seed, model.num_pdfs,
                                  model.device)
        self.served = []        # (pool index, olabels (U, T) CPU, scores (U,) CPU) a batch
        self.ll = {}            # pool index -> the window's last log-likelihoods of it
        self.span_s = {"am.gmm": 0.0, "decoder.decode_batch": 0.0}
        self.counters = {"decoder.batch_frames": 0}
        self.tally = {}         # the reference's live counts over the checked utterances

    def _decode(self, b: int):
        from dsr_tpu_torch.asr.am import gmm
        from dsr_tpu_torch.asr.decoder import topk_decoder as tk

        m, batch = self.model, self.pool[b]
        if self.spans:
            e0, e1 = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            e0.record()
        with span("bench.gmm"):
            ll = gmm.loglik(m.params, batch.feats)
        if self.spans:
            e1.record()
            torch.cuda.synchronize()
            self.span_s["am.gmm"] += e0.elapsed_time(e1) * 1e-3
            t0 = time.perf_counter()
        with span("bench.decode_batch"):
            olabs, scores = tk.decode_batch(m.tg, ll, batch.lengths, kcap=m.kcap, beam=m.beam)
        if self.spans:
            torch.cuda.synchronize()
            self.span_s["decoder.decode_batch"] += time.perf_counter() - t0
            self.counters["decoder.batch_frames"] += int(batch.feats.shape[1])
        return ll, olabs, scores

    def warm(self):
        """One decode of the pool batch with the most frames (builds and
        loads the select kernel; the allocator then holds blocks as large
        as any batch's tables), and the GMM at every other batch's shape.
        The spans start afresh after it."""
        from dsr_tpu_torch.asr.am import gmm

        longest = max(range(len(self.pool)), key=lambda b: self.pool[b].feats.shape[1])
        self._decode(longest)
        for b in range(len(self.pool)):
            if b != longest:
                gmm.loglik(self.model.params, self.pool[b].feats)
        self.span_s = dict.fromkeys(self.span_s, 0.0)
        self.counters["decoder.batch_frames"] = 0

    def serve(self, seconds: float):
        """The closed loop for `seconds`: -> (t0, t_end, latencies (s) a
        request, audio seconds completed, requests attempted)."""
        lat, audio, i = [], 0.0, 0
        t0 = time.perf_counter()
        while i == 0 or time.perf_counter() - t0 < seconds:
            b = i % len(self.pool)
            td = time.perf_counter()
            ll, olabs, scores = self._decode(b)
            tdone = time.perf_counter()
            n = len(self.pool[b].lengths)
            lat += [tdone - td] * n
            audio += float(self.pool[b].lengths.sum()) / self.model.fps
            self.served.append((b, olabs, scores))
            self.ll[b] = ll
            self.counters.setdefault("window.batch_s", []).append(round(tdone - td, 4))
            i += 1
        return t0, tdone, np.asarray(lat), audio, len(lat)

    def release(self):
        """Free the program's state before the reference runs; the window's
        answers stay."""
        self.model.release()

    # ---- traced runs ---------------------------------------------------------

    def _decode_plain(self, b):
        spans, self.spans = self.spans, False
        try:
            return self._decode(b)
        finally:
            self.spans = spans

    def trace(self, profiled):
        """The profiled phase: pool batch 0 under the profiler (which runs
        it twice, `trace.profiled`)."""
        return profiled(lambda: self._decode_plain(0))

    def batch_work(self, b: int) -> dict:
        """Pool batch b's work by layer: the GMM over its utterances' frames,
        the decoder's at the reference's live counts a frame."""
        frames = int(self.pool[b].lengths.sum())
        per = {k: self.tally[k] / self.tally["active_rows"]
               for k in ("live_candidates", "live_slots")}
        cfg = self.model.config
        live_c, live_s = per["live_candidates"] * frames, per["live_slots"] * frames
        return {"gmm": counts.gmm(frames, self.pool[b].feats.shape[-1], self.model.num_pdfs,
                                  cfg["am"]["components"]),
                "decode_expand": counts.decode_expand(live_c),
                "select": counts.select(live_c, live_s, frames)}

    def work(self):
        """-> (work by layer of the profiled batch, work of the whole
        window); after `check`, whose reference counted the live tokens."""
        if not self.tally.get("active_rows"):
            return {}, None
        window = counts.Work()
        for b, _, _ in self.served:
            window = window + sum(self.batch_work(b).values(), counts.Work())
        rows = self.tally["active_rows"]
        self.counters.update({
            "decoder.live_candidates_per_row_frame": self.tally["live_candidates"] / rows,
            "decoder.live_slot_share": self.tally["live_slots"] / (rows * self.model.kcap)})
        return self.batch_work(0), window

    # ---- correctness ---------------------------------------------------------

    def sample(self, n: int) -> list:
        """(pool batch, row) pairs of the batches the window served: their
        longest utterance and n - 1 more drawn from the seed."""
        served = sorted({b for b, _, _ in self.served})
        pairs = [(b, r) for b in served for r in range(len(self.pool[b].lengths))]
        lens = np.array([self.pool[b].lengths[r] for b, r in pairs])
        first = int(np.argmax(lens))
        rng = np.random.default_rng([self.seed % (2**63), 7])
        rest = rng.choice(np.delete(np.arange(len(pairs)), first), min(n, len(pairs)) - 1,
                          replace=False)
        return [pairs[first]] + [pairs[i] for i in rest]

    def check(self, control: bool = False) -> list:
        """Compare the window's answers for a sample of utterances with the
        reference: -> [(name, value, limit)].  With control=True the
        reference a step below float32 takes the program's place."""
        m = self.model
        g = m.task.graph
        dev = m.device
        limits = self.limits
        sample = self.sample(limits["sample"])
        by_batch = {}
        for b, r in sample:
            by_batch.setdefault(b, []).append(r)
        prog_ll = {b: self.ll[b][rows].float() for b, rows in by_batch.items()}
        graph = ref.Graph(g.src, g.pdf, g.olabel, g.weight, g.dst, g.start, g.final_weight,
                          g.num_states, dev, torch.float32)
        ll_gap, score_gap, mism, n_cmp = 0.0, 0.0, 0, 0
        for b, rows in by_batch.items():
            feats = self.pool[b].feats[rows]
            lens = self.pool[b].lengths[rows]
            r_ll = ref.gmm_loglik(feats, m.means, m.variances, m.logw, "float64")
            words_r, score_r = ref.decode(graph, r_ll.float(), lens, m.kcap, m.beam,
                                          tally=None if control else self.tally)
            if control:
                c_ll = ref.gmm_loglik(feats, m.means, m.variances, m.logw, "control")
                words_c, score_c = ref.decode(graph, c_ll, lens, m.kcap, m.beam, low=True)
                answers = [(c_ll, words_c, score_c)]
            else:
                answers = [(prog_ll[b], _words(olabs[rows]), scores[rows].double().numpy())
                           for bb, olabs, scores in self.served if bb == b]
            for a_ll, words, scores in answers:
                for i, n in enumerate(lens):
                    d = (a_ll[i, :n].double() - r_ll[i, :n]).abs().max()
                    ll_gap = max(ll_gap, float(d / r_ll[i, :n].abs().max()))
                    score_gap = max(score_gap, float(abs(scores[i] - score_r[i]) / abs(score_r[i])))
                    mism += words[i] != words_r[i]
                    n_cmp += 1
        self.counters["check.answers_compared"] = n_cmp
        lim = limits["limits"]
        return [("ll_gap", ll_gap, lim["ll_gap"]),
                ("score_gap", score_gap, lim["score_gap"]),
                ("word_mismatch", mism / max(n_cmp, 1), lim["word_mismatch"])]


def _words(olabs: torch.Tensor) -> list:
    return [[int(w) for w in row if w != 0] for row in olabs.tolist()]
