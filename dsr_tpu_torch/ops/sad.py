"""Speech-activity detection: energy and Sohn likelihood-ratio detectors
(PyTorch), and the utterance segmenter.

Counterpart of `dsr_tpu/ops/sad.py`.  The energy detector's noise floor
and Sohn's decision-directed prior are true recurrences: each is a Python
loop over frames of float32 ops on the device of the input.  What depends
on the recurrence's state only through a frame's own values (the
thresholds, the log-likelihood ratio) is computed for all frames after
the loop, with the scan body's arithmetic.  The hangover is exact integer
logic: a frame is active, or one of the `hangover` frames before it was,
which is a sliding count over the frames.  `segments_from_vad` runs on
the host (numpy), as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


def _hangover(active: torch.Tensor, hangover: int) -> torch.Tensor:
    """The scans' `dec = active | (hang > 0)` with `hang` reset to
    `hangover` by an active frame and counted down otherwise: frame t is
    on iff some frame in t - hangover .. t is active.  → int32."""
    c = torch.cumsum(active.to(torch.int32), 0)
    before = torch.cat([c.new_zeros(hangover + 1), c])[:c.shape[0]]   # c[t - hangover - 1]
    return (c - before > 0).to(torch.int32)


def energy_vad(P_frames: torch.Tensor, threshold_db: float = 6.0,
               hangover: int = 8) -> torch.Tensor:
    """P_frames: (T,) frame powers → (T,) int32 decisions."""
    logp = 10.0 * torch.log10(torch.clamp_min(P_frames.to(torch.float32), 1e-12))
    floor = logp[0]
    floors = []
    for t in range(logp.shape[0]):
        lp = logp[t]
        floor = torch.where(lp < floor, 0.9 * floor + 0.1 * lp, floor + 0.05)
        floors.append(floor)
    active = logp > torch.stack(floors) + threshold_db
    return _hangover(active, hangover)


def sohn_vad(
    P: torch.Tensor,
    noise_psd: torch.Tensor,
    prior_snr_alpha: float = 0.98,
    threshold: float = 0.0,
    hangover: int = 8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """P: (T, K) powers; noise_psd: (K,) → (decisions (T,) int32, llr (T,))."""
    gamma = P.to(torch.float32) / torch.clamp_min(noise_psd.to(torch.float32), 1e-12)
    ml = (1 - prior_snr_alpha) * torch.clamp_min(gamma - 1, 0)
    gain = torch.ones(P.shape[1], dtype=torch.float32, device=P.device)
    xis = []
    for t in range(P.shape[0]):
        xi = torch.clamp_min(prior_snr_alpha * gain ** 2 * gamma[t] + ml[t], 1e-3)
        gain = xi / (1 + xi)
        xis.append(xi)
    xi = torch.stack(xis)
    llr = torch.mean(gamma * xi / (1 + xi) - torch.log1p(xi), dim=-1)
    return _hangover(llr > threshold, hangover), llr


def segments_from_vad(decisions, min_speech: int = 10, min_gap: int = 15,
                      pad: int = 5):
    """Utterance segmenter over frame-level VAD decisions (the reference's
    segmenter role).

    Merges speech runs separated by < min_gap silence frames, drops runs
    shorter than min_speech, and pads each segment by `pad` frames.
    Returns [(start_frame, end_frame)].  Host-side (numpy/list) utility:
    a tensor is copied to the host.
    """
    if isinstance(decisions, torch.Tensor):
        decisions = decisions.cpu().numpy()
    d = np.asarray(decisions).astype(bool)
    T = len(d)
    runs = []
    t = 0
    while t < T:
        if d[t]:
            s = t
            while t < T and d[t]:
                t += 1
            runs.append([s, t])
        else:
            t += 1
    # merge close runs
    merged = []
    for r in runs:
        if merged and r[0] - merged[-1][1] < min_gap:
            merged[-1][1] = r[1]
        else:
            merged.append(r)
    out = []
    for s, e in merged:
        if e - s >= min_speech:
            out.append((max(0, s - pad), min(T, e + pad)))
    return out
