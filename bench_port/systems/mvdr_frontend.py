"""The MVDR front-end cells: blocks of array audio, resident on
the card, through the port's serving path, in a closed loop with a few
groups in flight.

A request is one block.  Blocks go in groups of `group`, each group a
bank staged once (`ops/filterbank.stage_for_beamform`).  For a group: the
MVDR weights of its blocks' talkers (`ops/beamforming.steering_vectors`
and `mvdr_weights_from_inv`, batched), one fused analysis + beamform
launch a block (`analysis_beamform_staged`, the buffer's index read on
the card), then for the group at once the synthesis (the enhanced
waveforms), subband MFCC, CMN and the GMM's log-likelihoods.  At most
`ahead` groups are in flight: after dispatching one the host waits for
the oldest when `ahead` are out.  A block completes when the host has
seen its group's completion event; its outputs stay on the card, where
the decoder reads them.

The program gets the array's positions, the talkers' delays, the staged
audio and the GMM's parameters, all made here; the reference
(`reference/mvdr_frontend.py`) gets the same positions, talkers, audio and
parameters and the shipped prototype file, and works out the rest.
"""

from __future__ import annotations

import collections
import importlib
import time

import numpy as np
import torch

from bench_port import counts
from bench_port.generators import array_blocks
from bench_port.reference import mvdr_frontend as ref
from bench_port.trace import span


class Model:
    def __init__(self, config: dict, device):
        from dsr_tpu_torch.config import FilterbankConfig
        from dsr_tpu_torch.ops import beamforming as bf
        from dsr_tpu_torch.utils import design

        self.config, self.device = config, torch.device(device)
        self.fb = FilterbankConfig(**config["filterbank"])
        self.fs = float(config["sample_rate"])
        self.mics = array_blocks.array_positions(config["array"])
        gamma = bf.diffuse_coherence(self.mics, self.fb.M, self.fs,
                                     config["array"]["sound_speed"], self.device)
        self.gamma_inv = bf.mvdr_precompute(gamma, config["beamformer"]["diagonal_loading"])
        key = (f"proto-M{self.fb.M}-m{self.fb.m}-r{self.fb.r}-b{self.fb.rolloff:g}"
               f"-j{self.fb.joint_iters}.npz")
        self.prototype_file = str(design.PROTOTYPE_DIR / key)
        with np.load(self.prototype_file) as z:
            self.delay = int(z["delay"])

    def release(self):
        self.gamma_inv = None


class Cell:
    def __init__(self, model: Model, traffic: dict, limits: dict, seed: int,
                 spans: bool = False):
        from dsr_tpu_torch.asr.am.gmm import GmmParams
        from dsr_tpu_torch.ops import filterbank as fb

        self.model, self.traffic, self.seed, self.spans = model, traffic, seed, spans
        dev = model.device
        gen = importlib.import_module(f"bench_port.generators.{traffic['generator']}")
        self.bank, self.talkers = gen.make_pool(model.config, traffic, seed, dev)
        B, N, S = self.bank.shape
        G = traffic["group"]
        if B % G:
            raise ValueError(f"a pool of {B} blocks is not whole groups of {G}")
        self.S, self.G, self.N = S, G, N
        self.T = fb.num_frames(S, model.fb)
        self.K = model.fb.num_bins
        self.banks = [fb.stage_for_beamform(self.bank[i:i + G]) for i in range(0, B, G)]
        c = model.config["array"]["sound_speed"]
        self.taus = torch.as_tensor(array_blocks.delays_s(model.mics, self.talkers, c),
                                    dtype=torch.float32, device=dev)
        self.idx = [torch.tensor(i, dtype=torch.int32, device=dev) for i in range(G)]
        am = model.config["am"]
        gen = torch.Generator(device=dev)
        gen.manual_seed((seed + 1) % (2**63))
        shape = (am["states"], am["components"], am["dims"])
        self.means = am["mean_std"] * torch.randn(shape, generator=gen, device=dev)
        lo, hi = am["var_range"]
        self.variances = lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)
        self.logw = torch.log_softmax(torch.randn(shape[:2], generator=gen, device=dev), -1)
        self.params = GmmParams(self.means, self.variances, self.logw).to(dev)
        self.limits = limits
        self.kept = []           # the reservoir: (group index, outputs)
        self.rng = np.random.default_rng([seed % (2**63), 11])
        self.dispatched = 0
        self.groups_served = 0
        self.span_s = collections.defaultdict(float)
        self.counters = {}

    STAGES = ("frontend.weights", "frontend.fused", "frontend.synthesis", "frontend.mfcc",
              "frontend.cmn", "am.gmm")

    def _group(self, g: int):
        from dsr_tpu_torch.asr.am import gmm
        from dsr_tpu_torch.ops import beamforming as bf
        from dsr_tpu_torch.ops import features as ft
        from dsr_tpu_torch.ops import filterbank as fb

        m, fe = self.model, self.model.config["frontend"]
        M = m.fb.M
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)] if self.spans else None

        def mark(i):
            if ev:
                ev[i].record()

        mark(0)
        with span("bench.weights"):
            v = bf.steering_vectors(self.taus[g * self.G:(g + 1) * self.G], M, m.fs)
            w = bf.mvdr_weights_from_inv(v, m.gamma_inv)
        mark(1)
        bank = self.banks[g]
        with span("bench.fused"):
            Y = torch.stack([fb.analysis_beamform_staged(bank, self.idx[i], w[i], m.fb, self.S)
                             for i in range(self.G)])
        mark(2)
        with span("bench.synthesis"):
            y = fb.synthesis(Y, m.fb, self.S)
        mark(3)
        with span("bench.mfcc"):
            c = ft.mfcc_from_subbands(Y, M, m.fs, num_mel=fe["num_mel"],
                                      num_cepstra=fe["num_cepstra"], fmin=fe["fmin"])
        mark(4)
        with span("bench.cmn"):
            feats = ft.cmn(c)
        mark(5)
        with span("bench.gmm"):
            ll = gmm.loglik(self.params, feats)
        mark(6)
        return (w, Y, y, feats, ll), ev

    def _keep(self, g, outs, limit: int):
        """Reservoir sampling of the dispatched groups' outputs, from the seed."""
        i = self.dispatched
        if i < limit:
            self.kept.append((g, outs))
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < limit:
                self.kept[j] = (g, outs)
        self.dispatched += 1

    def _loop(self, seconds=None, groups=None, keep: int = 0):
        ahead = self.traffic["ahead"]
        n_groups = len(self.banks)
        out, audio, done = collections.deque(), 0.0, []
        t0 = time.perf_counter()
        i = 0

        def finish():
            td, e, ev = out.popleft()
            with span("bench.wait"):
                e.synchronize()
            done.append((td, time.perf_counter()))
            if ev:
                for name, a, b in zip(self.STAGES, ev[:-1], ev[1:]):
                    self.span_s[name] += a.elapsed_time(b) * 1e-3

        while (i < groups) if groups is not None else (i == 0 or time.perf_counter() - t0 < seconds):
            g = i % n_groups
            td = time.perf_counter()
            outs, ev = self._group(g)
            e = torch.cuda.Event() if self.model.device.type == "cuda" else _Done()
            e.record()
            out.append((td, e, ev))
            if keep:
                self._keep(g, outs, keep)
            i += 1
            while len(out) >= ahead:
                finish()
        while out:
            finish()
        audio = len(done) * self.G * self.S / self.model.fs
        lat = np.repeat([b - a for a, b in done], self.G)
        return t0, done[-1][1], lat, audio, len(lat)

    def warm(self):
        """Every shape the loop uses: one pass over the pool's groups."""
        self._loop(groups=len(self.banks))
        self.span_s.clear()

    def serve(self, seconds: float):
        """The closed loop for `seconds`: -> (t0, t_end, latencies (s) a
        request, audio seconds completed, requests attempted); keeps the
        outputs of `sample_groups` groups drawn from the seed."""
        out = self._loop(seconds=seconds, keep=self.limits["sample_groups"])
        self.groups_served = out[4] // self.G
        return out

    def release(self):
        """Free the program's state before the reference runs; the kept
        answers stay."""
        self.model.release()
        self.banks = self.params = None

    # ---- traced runs ---------------------------------------------------------

    def group_work(self) -> dict:
        m, fe, am = self.model, self.model.config["frontend"], self.model.config["am"]
        fbc = m.fb
        start = min(max(fbc.L - fbc.D + m.delay, 0), (self.T - 1) * fbc.D + fbc.L - self.S)
        return {"weights": counts.mvdr_weights(self.G, self.K, self.N),
                "analysis_beamform": self.G * counts.analysis_beamform(
                    self.N, self.S, self.T, fbc.M, fbc.m),
                "synthesis": counts.synthesis(self.G, self.T, fbc.M, fbc.m, fbc.r, start, self.S),
                "mfcc_cmn": counts.mfcc_cmn(self.G, self.T, self.K, fe["num_mel"],
                                            fe["num_cepstra"]),
                "gmm": counts.gmm(self.G * self.T, am["dims"], am["states"], am["components"])}

    def trace(self, profiled):
        """The profiled phase: `trace_groups` groups under the profiler."""
        spans, self.spans = self.spans, False
        try:
            return profiled(lambda: self._loop(groups=self.traffic["trace_groups"]))
        finally:
            self.spans = spans

    def work(self):
        """-> (work by layer of the profiled groups, work of the whole window)."""
        n = self.traffic["trace_groups"]
        per_group = self.group_work()
        one = sum(per_group.values(), counts.Work())
        return {k: w * n for k, w in per_group.items()}, one * self.groups_served

    # ---- correctness ---------------------------------------------------------

    def check(self, control: bool = False) -> list:
        m, limits = self.model, self.limits
        kept = self.kept
        reference = ref.Frontend(m.config, m.prototype_file, m.mics, m.device)
        low = (ref.Frontend(m.config, m.prototype_file, m.mics, m.device, "control")
               if control else None)
        gaps = dict.fromkeys(("weights_gap", "subbands_gap", "waveform_gap", "features_gap",
                              "ll_gap"), 0.0)
        n = 0
        for g, (w, Y, y, feats, ll) in kept:
            for j in range(self.G):
                blk = g * self.G + j
                x = self.bank[blk]
                rw = reference.weights(self.talkers[blk])
                rY = reference.beamform(reference.analysis(x), rw)
                r = (rw, rY, reference.synthesis(rY, self.S), reference.features(rY))
                r = r + (reference.loglik(r[3], self.means, self.variances, self.logw),)
                if control:
                    cw = low.weights(self.talkers[blk])
                    cY = low.beamform(low.analysis(x), cw)
                    cf = low.features(cY)
                    a = (cw, cY, low.synthesis(cY, self.S), cf,
                         low.loglik(cf, self.means, self.variances, self.logw))
                else:
                    a = (w[j], Y[j], y[j], feats[j], ll[j])
                for name, p, q in zip(gaps, a, r):
                    d = (p.to(q.dtype) - q).abs().max() / q.abs().max()
                    gaps[name] = max(gaps[name], float(d))
                n += 1
        self.counters["check.blocks_compared"] = n
        lim = limits["limits"]
        return [(k, v, lim[k]) for k, v in gaps.items()]


class _Done:
    """A completion event for CPU tensors, whose work is done on return."""

    def record(self):
        pass

    def synchronize(self):
        pass
