"""Batches of utterances for the LVCSR decode: sentences of a synthetic
task's trigram text rendered as acoustic features.

The task (`configs/<config>.json`, key `lvcsr`) is the port's synthetic
LVCSR task; this module holds its own copies of the task's random
lexicon and of the successor table of its sparse-Markov text (the first
draws of the task's generator, as `dsr_tpu_torch/asr/lvcsr.py` makes them),
so in-domain sentences come from the same chain the trigram was trained
on.  A sentence is rendered as `synthesize_utterance` renders it: each
word's phones, then silence with probability `sil_prob`, each HMM state
held 2 to 4 frames; features are `noise` N(0, 1) on every pdf dimension
plus `scale` on the frame's own pdf.

Sizes do not depend on the seed.  The lengths of the pool's utterances
come from the mix's own `shape_seed`: natural renderings of the chain.
The run's seed then draws, for each length, a sentence whose states can
fill it and durations that sum to it exactly, and the noise.  So every
seed gives the decoder the same frames in every batch and other words.

Params (`traffic/<mix>.json`): `utterances_per_batch`, `pool_batches`,
`words` [min, max], `sil_prob`, `dur` [min, max] frames a state,
`scale`, `noise`, `shape_seed`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

PHONES = ("aa ae ah ao aw ay b ch d dh eh er ey f g hh ih iy jh k l m n ng ow oy "
          "p r s sh t th uh uw v w y z zh").split()
SIL = len(PHONES)          # phone index of silence (phone id SIL + 1)


def lexicon(vocab_size: int, seed: int, branching: int):
    """(pronunciations, successor table): word i's phone indices and its
    `branching` possible successors, drawn as the task draws them."""
    rng = np.random.default_rng(seed)
    prons = []
    for _ in range(vocab_size):
        n = int(rng.integers(2, 8))
        prons.append(rng.integers(0, len(PHONES), n))
    succ = rng.integers(0, vocab_size, size=(vocab_size, branching))
    return prons, succ


@dataclass
class Utterance:
    words: list          # word indices (word id = index + 1 in the task's symbol table)
    frames: int


def _sentence(rng, succ, words, sil_prob):
    V, B = succ.shape
    n = int(rng.integers(words[0], words[1] + 1))
    w = int(rng.integers(0, V))
    out = [w]
    for _ in range(n - 1):
        w = int(succ[w, int(rng.integers(0, B))])
        out.append(w)
    sil = rng.random(n) < sil_prob
    return out, sil


def _phones(prons, ws, sil):
    parts = []
    for w, s in zip(ws, sil):
        parts.append(prons[w])
        if s:
            parts.append(np.array([SIL]))
    return np.concatenate(parts)


def shapes(prons, succ, p, spp: int) -> np.ndarray:
    """(pool_batches, utterances_per_batch) frame counts from the mix's
    shape_seed: natural renderings, independent of the run's seed."""
    rng = np.random.default_rng(p["shape_seed"])
    lo, hi = p["dur"]
    n = p["pool_batches"] * p["utterances_per_batch"]
    out = np.empty(n, np.int64)
    for i in range(n):
        ws, sil = _sentence(rng, succ, p["words"], p["sil_prob"])
        states = spp * len(_phones(prons, ws, sil))
        out[i] = int(rng.integers(lo, hi + 1, states).sum())
    return out.reshape(p["pool_batches"], p["utterances_per_batch"])


def render(prons, succ, frames: int, rng, p, spp: int) -> tuple[Utterance, np.ndarray]:
    """A sentence of exactly `frames` frames and its (frames,) pdf indices."""
    lo, hi = p["dur"]
    for _ in range(10_000):
        ws, sil = _sentence(rng, succ, p["words"], p["sil_prob"])
        ph = _phones(prons, ws, sil)
        n = spp * len(ph)
        if lo * n <= frames <= hi * n:
            break
    else:
        raise ValueError(f"no sentence fills {frames} frames")
    extra = np.bincount(rng.choice(n * (hi - lo), frames - lo * n, replace=False) // (hi - lo),
                        minlength=n)
    pdfs = (ph[:, None] * spp + np.arange(spp)).reshape(-1)
    return Utterance(ws, frames), np.repeat(pdfs, lo + extra)


@dataclass
class Batch:
    feats: torch.Tensor      # (U, T, P) float32 on the device
    lengths: np.ndarray      # (U,) frames
    utts: list               # Utterance per row


def make_pool(task_cfg: dict, p: dict, seed: int, num_pdfs: int, device) -> list:
    """The pool of batches: host rendering from the seed, features made on
    the device by one generator seeded from it."""
    spp = task_cfg["states_per_phone"]
    prons, succ = lexicon(task_cfg["vocab_size"], task_cfg["seed"], task_cfg["branching"])
    lens = shapes(prons, succ, p, spp)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2**63))
    pool = []
    for b in range(p["pool_batches"]):
        order = rng.permutation(lens.shape[1])
        utts, rows = [], []
        for frames in lens[b][order]:
            u, pdf = render(prons, succ, int(frames), rng, p, spp)
            utts.append(u)
            rows.append(pdf)
        U, T = len(rows), max(len(r) for r in rows)
        pdf = np.full((U, T), -1, np.int64)
        for i, r in enumerate(rows):
            pdf[i, :len(r)] = r
        pdf_t = torch.as_tensor(pdf, device=device)
        feats = p["noise"] * torch.randn((U, T, num_pdfs), generator=gen, device=device)
        hot = (pdf_t >= 0).to(torch.float32)[..., None] * p["scale"]
        feats.scatter_add_(2, pdf_t.clamp(min=0)[..., None], hot)
        pool.append(Batch(feats, np.array([u.frames for u in utts]), utts))
    return pool
