"""The port's WAV I/O, sample streamer, block converter and batched loader
(`dsr_tpu_torch/utils/audio.py`, its native sources in
`dsr_tpu_torch/utils/csrc/`) against the JAX package's
(`dsr_tpu/utils/audio.py`, `native/`).

Both run the same C++, so everything is compared exactly: files written by
either package are byte-identical and read back bit-equal in the other;
the streamed blocks, the re-chunked blocks, the loader's batches, lengths
and skipped files are equal.
"""

import numpy as np
import pytest

from dsr_tpu.utils import audio as jaudio
from dsr_tpu_torch.utils import audio


def _signal(ch, frames, seed):
    return (0.3 * np.random.default_rng(seed).standard_normal((ch, frames))).astype(np.float32)


@pytest.mark.parametrize("pcm16", [True, False])
def test_wav_files_are_identical_and_read_back_bit_equal(tmp_path, pcm16):
    x = _signal(3, 4567, 1)                    # values beyond ±1 exercise the PCM16 clip
    mine, theirs = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    audio.write_wav(mine, x, 16000, pcm16=pcm16)
    jaudio.write_wav(theirs, x, 16000, pcm16=pcm16)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    for path in (mine, theirs):
        y, rate = audio.read_wav(path)
        y_ref, rate_ref = jaudio.read_wav(path)
        assert rate == rate_ref == 16000 and y.dtype == y_ref.dtype == np.float32
        assert y.shape == (3, 4567) and np.array_equal(y, y_ref)
    if not pcm16:
        assert np.array_equal(audio.read_wav(mine)[0], x)
    audio.write_wav(mine, x[0], 8000)          # (frames,) is one channel
    assert audio.read_wav(mine)[0].shape == (1, 4567)
    with pytest.raises(IOError, match="missing.wav.*-1"):
        audio.read_wav(str(tmp_path / "missing.wav"))


def test_sample_stream_and_block_converter_match(tmp_path):
    path = str(tmp_path / "s.wav")
    audio.write_wav(path, _signal(4, 10_007, 2), 16000, pcm16=False)
    with audio.SampleStream(path, 1000, capacity_frames=3000) as s, \
            jaudio.SampleStream(path, 1000, capacity_frames=3000) as j:
        assert (s.channels, s.sample_rate) == (j.channels, j.sample_rate) == (4, 16000)
        mine, theirs = list(s), list(j)
    assert len(mine) == len(theirs) == 11
    assert all(np.array_equal(a, b) for a, b in zip(mine, theirs))
    with pytest.raises(IOError):
        audio.SampleStream(str(tmp_path / "missing.wav"), 100)

    # irregular pushes through both converters, then the zero-padded tail
    rng = np.random.default_rng(3)
    x = _signal(2, 3001, 4)
    cuts = np.sort(rng.choice(np.arange(1, 3001), 9, replace=False))
    conv, jconv = audio.BlockSizeConverter(256), jaudio.BlockSizeConverter(256)
    outs, jouts = [], []
    for blk in np.split(x, cuts, axis=-1):
        outs += conv.push(blk)
        jouts += jconv.push(blk)
    outs.append(conv.flush())
    jouts.append(jconv.flush())
    assert len(outs) == len(jouts) == 12
    assert all(np.array_equal(a, b) for a, b in zip(outs, jouts))
    assert conv.flush() is None
    with pytest.raises(ValueError):
        audio.BlockSizeConverter(0)


def test_batch_loader_matches_with_a_missing_file(tmp_path):
    paths = []
    for i in range(7):
        p = str(tmp_path / f"u{i}.wav")
        audio.write_wav(p, _signal(2, 1000 + 137 * i, 10 + i), 16000)
        paths.append(p)
    paths.insert(3, str(tmp_path / "missing.wav"))
    kw = dict(batch=3, max_frames=1900, max_channels=2, workers=2)
    with audio.BatchLoader(paths, **kw) as loader, jaudio.BatchLoader(paths, **kw) as jloader:
        mine, theirs = list(loader), list(jloader)
        assert loader.skipped == jloader.skipped
    assert loader.skipped == [(paths[3], -1)]
    assert len(mine) == len(theirs) == 3
    for (a, la), (b, lb) in zip(mine, theirs):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
        assert np.array_equal(la, lb)
    assert [len(la) for _, la in mine] == [3, 3, 1]
    # each row is read_wav of its file, truncated to max_frames, zero-padded
    good = [p for p in paths if "missing" not in p]
    rows = [r for a, _ in mine for r in a]
    lens = [int(n) for _, la in mine for n in la]
    for p, row, n in zip(good, rows, lens):
        x = audio.read_wav(p)[0][:, :1900]
        assert n == x.shape[1] and np.array_equal(row[:, :n], x) and not row[:, n:].any()

    # a batch of mixed channel counts raises in both packages
    mono = str(tmp_path / "mono.wav")
    audio.write_wav(mono, _signal(1, 500, 30), 16000)
    for mod in (audio, jaudio):
        with mod.BatchLoader([paths[0], mono], batch=2, max_frames=2000, max_channels=2) as ld:
            with pytest.raises(ValueError, match="mixed channel counts"):
                next(ld)
