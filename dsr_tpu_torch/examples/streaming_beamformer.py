"""Streaming DSR: native ring-buffer WAV reader → chunked beamforming.

Counterpart of `examples/streaming_beamformer.py`: writes a synthetic
8-channel float32 WAV, streams it through the native sample streamer
(`utils.audio.SampleStream`) into `DsrPipeline.process_streaming` (GSC
with the Zelinski post-filter, its adaptive state carried from block to
block) and writes the enhanced single-channel WAV.

    python -m dsr_tpu_torch.examples.streaming_beamformer
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from dsr_tpu_torch.config import ArrayGeometry, BeamformerConfig, FilterbankConfig
from dsr_tpu_torch.pipeline import DsrPipeline
from dsr_tpu_torch.utils import audio, room

SR = 16000.0


def main(device=None, out_dir: str | None = None) -> dict:
    """Stream the recording through the pipeline; the WAV files go to
    `out_dir` (a temporary directory, removed at the end, by default)."""
    geom = ArrayGeometry.linear(8, 0.04)
    POS = np.asarray(geom.positions)
    pos = np.array([0.0, 2.0, 0.0])
    rng = np.random.default_rng(0)
    S = 64000
    t = np.arange(S) / SR
    src = (np.sin(2 * np.pi * 300 * t) + 0.5 * np.sin(2 * np.pi * 880 * t)) * 0.2
    x = room.simulate(src, POS, pos, SR, snr_db=5.0, rng=rng).astype(np.float32)

    with tempfile.TemporaryDirectory() as scratch:
        tmp = out_dir or scratch
        in_path = os.path.join(tmp, "array8.wav")
        out_path = os.path.join(tmp, "enhanced.wav")
        audio.write_wav(in_path, x, int(SR), pcm16=False)

        pipe = DsrPipeline(fb=FilterbankConfig(M=256, m=4, r=2), geometry=geom,
                           beamformer=BeamformerConfig(kind="gsc"), postfilter="zelinski",
                           device=device)
        out = []
        with audio.SampleStream(in_path, block_frames=8000) as stream:
            print(f"streaming {in_path}: {stream.channels} ch @ {stream.sample_rate} Hz")
            for y in pipe.process_streaming(stream, pos):
                out.append(y)
                print(f"  emitted {len(y)} enhanced samples")
        y = torch.cat(out)[:S].cpu().numpy()
        audio.write_wav(out_path, y, int(SR))
        noisy_ref = x[0]
        snr_in = 10 * np.log10(np.mean(src**2) / np.mean((noisy_ref - src) ** 2))
        print(f"wrote {out_path} ({len(y)} samples); input ch0 SNR ≈ {snr_in:.1f} dB")
    return {"enhanced": y, "input": x, "source": src, "snr_in_db": snr_in, "path": out_path}


if __name__ == "__main__":
    main()
