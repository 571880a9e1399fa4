"""The port's examples (`dsr_tpu_torch/examples/`) on the CPU.

`streaming_asr` and `streaming_beamformer` run at their own sizes with
their built-in assertions (streamed words == offline words; the enhanced
stream's WAV).  The serving example runs at a smaller size than its own
(6 utterances of 1 s instead of 16 of 4 s, on the V = 300 graph instead
of `LvcsrConfig()`'s V = 2000, whose CPU decode would take minutes): its
loader's batches are `read_wav` of each file bitwise, and the pipelined
loop's decodes equal the sequential baseline's bitwise.
"""

import numpy as np
import torch

from dsr_tpu_torch.asr import lvcsr
from dsr_tpu_torch.examples import serving_pipeline, streaming_asr, streaming_beamformer
from dsr_tpu_torch.utils import audio


def test_streaming_asr_streamed_equals_offline():
    out = streaming_asr.main(device="cpu")
    assert out["streamed"] == out["offline"] and len(out["offline"]) >= 3


def test_streaming_beamformer_writes_the_enhanced_stream(tmp_path):
    out = streaming_beamformer.main(device="cpu", out_dir=str(tmp_path))
    y = out["enhanced"]
    assert y.shape == (64000,) and np.isfinite(y).all()
    back, rate = audio.read_wav(out["path"])
    assert rate == 16000 and np.abs(back[0] - y).max() <= 1 / 32768 + 1e-7   # PCM16 rounding
    assert np.array_equal(audio.read_wav(str(tmp_path / "array8.wav"))[0], out["input"])


def test_serving_pipelined_equals_sequential(tmp_path, monkeypatch):
    monkeypatch.setattr(serving_pipeline, "SECS", 1.0)
    task = lvcsr.build_task(lvcsr.LvcsrConfig(vocab_size=300, n_tokens=5000, branching=3))
    server = serving_pipeline.make_server("cpu", task)
    paths = serving_pipeline.make_corpus(str(tmp_path), 6)
    with audio.BatchLoader(paths, 4, max_frames=16000, max_channels=8) as loader:
        batches = list(loader)
    assert [a.shape for a, _ in batches] == [(4, 8, 16000), (2, 8, 16000)]
    rows = [r for a, _ in batches for r in a]
    assert all(np.array_equal(r, audio.read_wav(p)[0]) for r, p in zip(rows, paths))
    n_pipe, pipe = serving_pipeline.serve_pipelined(server, paths, depth=1)
    n_seq, seq = serving_pipeline.serve_sequential(server, paths)
    assert n_pipe == n_seq == 2
    for (ol_p, sc_p), (ol_s, sc_s) in zip(pipe, seq):
        assert torch.equal(ol_p, ol_s) and torch.equal(sc_p, sc_s)
        assert torch.isfinite(sc_p).all()
    feats = server.features(torch.from_numpy(batches[0][0]))
    assert feats.shape == (4, 140, 13) and torch.isfinite(feats).all()
