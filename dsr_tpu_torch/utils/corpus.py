"""Synthetic small-vocabulary speech corpus with known transcripts.

The port's copy of `golden/corpus.py` (numpy only): each phone is a
formant triple rendered as a sum of sinusoids with a pitch-like fundamental
and a noise floor; words are phone sequences with random durations;
utterances are silence-separated word sequences.  The same rng draws in the
same order, so a seed gives the same arrays bit for bit.  The tables
(`PHONES`, `WORDS`, `VOCAB`) feed `asr/smallvocab.py` and `asr/phone_task.py`.
"""

from __future__ import annotations

import numpy as np

# 12 synthetic phones: (f1, f2, f3) "formant" frequencies in Hz.
PHONES = {
    "aa": (730, 1090, 2440),
    "iy": (270, 2290, 3010),
    "uw": (300, 870, 2240),
    "eh": (530, 1840, 2480),
    "ow": (570, 840, 2410),
    "sh": (2200, 3300, 4500),
    "ss": (3500, 4500, 5500),
    "mm": (280, 900, 2200),
    "nn": (320, 1400, 2500),
    "rr": (420, 1300, 1600),
    "kk": (1400, 2100, 3200),
    "tt": (1800, 3000, 4200),
}

# 10-word vocabulary as phone sequences.
WORDS = {
    "ash": ("aa", "sh"),
    "east": ("iy", "ss", "tt"),
    "oom": ("uw", "mm"),
    "echo": ("eh", "kk", "ow"),
    "moon": ("mm", "uw", "nn"),
    "tree": ("tt", "rr", "iy"),
    "oak": ("ow", "kk"),
    "mesh": ("mm", "eh", "sh"),
    "ria": ("rr", "iy", "aa"),
    "noose": ("nn", "uw", "ss"),
}

VOCAB = sorted(WORDS)


def render_phone(phone: str, dur: int, sr: float, rng: np.random.Generator) -> np.ndarray:
    f123 = PHONES[phone]
    t = np.arange(dur) / sr
    x = np.zeros(dur)
    f0 = rng.uniform(95, 125)  # pitch-like jitter per phone instance
    for amp, f in zip((1.0, 0.7, 0.4), f123):
        x += amp * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
        x += 0.15 * amp * np.sin(2 * np.pi * (f + f0) * t + rng.uniform(0, 2 * np.pi))
    x += 0.05 * rng.standard_normal(dur)
    env = np.hanning(2 * min(dur // 4, 160))
    half = len(env) // 2
    ramp = np.ones(dur)
    ramp[:half] = env[:half]
    ramp[-half:] = env[-half:] if half else 1.0
    return x * ramp * 0.3


def render_silence(dur: int, rng: np.random.Generator) -> np.ndarray:
    return 0.005 * rng.standard_normal(dur)


def make_utterance(
    words: list[str], sr: float = 16000.0, rng: np.random.Generator | None = None
) -> np.ndarray:
    rng = np.random.default_rng(0) if rng is None else rng
    segs = [render_silence(rng.integers(800, 1600), rng)]
    for w in words:
        for ph in WORDS[w]:
            segs.append(render_phone(ph, int(rng.integers(1000, 1900)), sr, rng))
        segs.append(render_silence(rng.integers(800, 1600), rng))
    return np.concatenate(segs)


def make_corpus(
    num_utts: int,
    min_words: int = 2,
    max_words: int = 5,
    sr: float = 16000.0,
    seed: int = 0,
) -> list[tuple[list[str], np.ndarray]]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_utts):
        n = int(rng.integers(min_words, max_words + 1))
        words = [VOCAB[int(rng.integers(0, len(VOCAB)))] for _ in range(n)]
        out.append((words, make_utterance(words, sr, rng)))
    return out
