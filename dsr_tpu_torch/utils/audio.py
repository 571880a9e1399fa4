"""Audio I/O and native sample streaming (ctypes binding to `csrc/audio.cpp`).

Counterpart of `dsr_tpu/utils/audio.py`, with the same names, arguments
and contracts: host numpy arrays shaped (channels, frames).  The native
library (the port's copies of `native/wavio.cpp` and `native/loader.cpp`,
built by `ops/cuda/build.py` with `g++` at first use) plays the
reference's `SampleFeature` and `BlockSizeConversion` roles: WAV read and
write (PCM16 and IEEE float32), a threaded ring-buffer streamer that
re-blocks a file into fixed-size frames, and a worker pool that loads a
corpus in order, in batches.  There is no Python fallback: a failed build
raises with the compiler's output, and an unreadable file raises `IOError`
naming the path and the native return code.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from dsr_tpu_torch.ops.cuda import build


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = build.library("audio")
    i32p = ctypes.POINTER(ctypes.c_int)
    i64p = ctypes.POINTER(ctypes.c_longlong)
    f32p = ctypes.POINTER(ctypes.c_float)
    for name, restype, argtypes in (
            ("dsr_wav_info", ctypes.c_int, [ctypes.c_char_p, i32p, i32p, i64p]),
            ("dsr_wav_read", ctypes.c_int, [ctypes.c_char_p, f32p, ctypes.c_longlong]),
            ("dsr_wav_write", ctypes.c_int, [ctypes.c_char_p, f32p, ctypes.c_longlong,
                                             ctypes.c_int, ctypes.c_int, ctypes.c_int]),
            ("dsr_stream_open", ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_longlong]),
            ("dsr_stream_channels", ctypes.c_int, [ctypes.c_void_p]),
            ("dsr_stream_rate", ctypes.c_int, [ctypes.c_void_p]),
            ("dsr_stream_pop", ctypes.c_longlong, [ctypes.c_void_p, f32p, ctypes.c_longlong]),
            ("dsr_stream_close", None, [ctypes.c_void_p]),
            ("dsr_loader_open", ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_int,
                                                  ctypes.c_longlong, ctypes.c_int]),
            ("dsr_loader_next", ctypes.c_int, [ctypes.c_void_p, f32p, i64p, i32p, i32p]),
            ("dsr_loader_close", None, [ctypes.c_void_p])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """→ (samples (channels, frames) float32 in [-1, 1], sample_rate)."""
    lib = _load()
    rate, ch, frames = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    rc = lib.dsr_wav_info(path.encode(), ctypes.byref(rate), ctypes.byref(ch),
                          ctypes.byref(frames))
    if rc != 0:
        raise IOError(f"cannot read the WAV header of {path} (native return code {rc})")
    total = frames.value * ch.value
    buf = np.empty(total, np.float32)
    rc = lib.dsr_wav_read(path.encode(), _ptr(buf, ctypes.c_float), total)
    if rc != 0:
        raise IOError(f"cannot read the samples of {path} (native return code {rc})")
    return buf.reshape(frames.value, ch.value).T.copy(), rate.value


def write_wav(path: str, samples: np.ndarray, sample_rate: int, pcm16: bool = True):
    """samples: (channels, frames) or (frames,) float32 in [-1, 1]."""
    x = np.asarray(samples, np.float32)
    if x.ndim == 1:
        x = x[None, :]
    inter = np.ascontiguousarray(x.T.reshape(-1))
    rc = _load().dsr_wav_write(path.encode(), _ptr(inter, ctypes.c_float), x.shape[1],
                               x.shape[0], int(sample_rate), 1 if pcm16 else 0)
    if rc != 0:
        raise IOError(f"cannot write {path} (native return code {rc})")


class SampleStream:
    """Native threaded streaming reader: pop fixed-size (channels, block)
    chunks from a WAV file (BlockSizeConversion + ring buffer)."""

    def __init__(self, path: str, block_frames: int, capacity_frames: int = 65536):
        self._lib = _load()
        self._h = self._lib.dsr_stream_open(path.encode(), capacity_frames)
        if not self._h:
            raise IOError(f"cannot open {path}")
        self.channels = self._lib.dsr_stream_channels(self._h)
        self.sample_rate = self._lib.dsr_stream_rate(self._h)
        self.block_frames = block_frames

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._h is None:
            raise StopIteration
        values = self.block_frames * self.channels
        buf = np.empty(values, np.float32)
        got = self._lib.dsr_stream_pop(self._h, _ptr(buf, ctypes.c_float), values)
        if got == 0:
            self.close()
            raise StopIteration
        return buf.reshape(self.block_frames, self.channels).T.copy()

    def close(self):
        if self._h is not None:
            self._lib.dsr_stream_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class BlockSizeConverter:
    """Re-chunk a stream of sample blocks to a fixed output block size.

    Upstream produces blocks of one size (e.g. the native SampleStream's
    read granularity), downstream stages want another (e.g. the
    filterbank's D-sample hop).  Works on (..., S) blocks; leading axes
    (channels) must be constant.

    >>> conv = BlockSizeConverter(512)
    >>> for blk in stream:
    ...     for out in conv.push(blk): ...   # list of (..., 512) blocks
    >>> tail = conv.flush()                  # remainder, zero-padded
    """

    def __init__(self, out_size: int):
        if out_size <= 0:
            raise ValueError(f"out_size must be positive; got {out_size}")
        self.out_size = int(out_size)
        self._buf: np.ndarray | None = None

    def push(self, block: np.ndarray) -> list[np.ndarray]:
        """Eager re-chunk: returns the complete output blocks and retains
        the tail.  Output blocks (and the retained tail) are copies: the
        caller may reuse its input buffer between pushes."""
        block = np.asarray(block)
        buf = block if self._buf is None else np.concatenate([self._buf, block], axis=-1)
        n = buf.shape[-1] // self.out_size
        out = [buf[..., i * self.out_size:(i + 1) * self.out_size].copy() for i in range(n)]
        self._buf = buf[..., n * self.out_size:].copy()
        return out

    def flush(self, pad: bool = True) -> np.ndarray | None:
        """Remaining samples as one final block (zero-padded if `pad`)."""
        buf, self._buf = self._buf, None
        if buf is None or buf.shape[-1] == 0:
            return None
        if pad and buf.shape[-1] < self.out_size:
            width = [(0, 0)] * (buf.ndim - 1) + [(0, self.out_size - buf.shape[-1])]
            buf = np.pad(buf, width)
        return buf


class BatchLoader:
    """Native batched corpus loader (`csrc/loader.cpp`): a C++ worker pool
    prefetches and decodes WAV files IN CORPUS ORDER while the card
    computes; batches arrive zero-padded to a fixed row stride with
    per-utterance frame counts.

    Iterating yields (audio (B, channels, frames_max), lengths (B,)) with
    B ≤ batch on the last batch, host numpy arrays.  All files in a batch
    must share a channel count ≤ max_channels (standard corpus layout);
    mixed corpora should be bucketed first.

    Error recovery: an unreadable corpus file does not wedge the loader
    (the native side consumes the failing slot and the next call
    continues): the valid prefix of the batch is yielded, the bad path is
    recorded in `self.skipped` as (path, rc), and iteration resumes with
    the following file.
    """

    def __init__(self, paths: list[str], batch: int, max_frames: int,
                 max_channels: int = 1, workers: int = 4):
        self._lib = _load()
        self.batch = batch
        self.max_channels = int(max_channels)
        self.max_values = int(max_frames) * int(max_channels)
        self.skipped: list[tuple[str, int]] = []
        self._paths = list(paths)
        self._consumed = 0         # corpus position (skipped files included)
        self._h = self._lib.dsr_loader_open("\n".join(paths).encode(), batch, self.max_values,
                                            workers)
        if not self._h:
            raise IOError("dsr_loader_open failed (empty corpus or bad args)")

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            if self._h is None:
                raise StopIteration
            out = np.empty((self.batch, self.max_values), np.float32)
            frames = np.empty(self.batch, np.int64)
            channels = np.empty(self.batch, np.int32)
            rates = np.empty(self.batch, np.int32)
            n = self._lib.dsr_loader_next(self._h, _ptr(out, ctypes.c_float),
                                          _ptr(frames, ctypes.c_longlong),
                                          _ptr(channels, ctypes.c_int), _ptr(rates, ctypes.c_int))
            if n < 0:
                # slots 0..pos-1 are valid, slot pos failed and was consumed
                # (the loader's contract): record it and yield the prefix
                pos = -n - 1
                self.skipped.append((self._paths[self._consumed + pos], int(frames[pos])))
                self._consumed += pos + 1
                n = pos
                if n == 0:
                    continue       # nothing valid this round; keep going
            elif n == 0:
                self.close()
                raise StopIteration
            else:
                self._consumed += n
            ch = int(channels[0])
            if not (channels[:n] == ch).all():
                raise ValueError(
                    "mixed channel counts in one batch "
                    f"({sorted(set(channels[:n].tolist()))}); bucket the "
                    "corpus by channel count first")
            if ch > self.max_channels or self.max_values % ch != 0:
                raise ValueError(
                    f"batch channel count {ch} exceeds or does not divide "
                    f"max_channels={self.max_channels} (row stride {self.max_values})")
            fmax = self.max_values // ch
            audio = out[:n].reshape(n, fmax, ch).transpose(0, 2, 1)
            self.rates = rates[:n].copy()
            return np.ascontiguousarray(audio), frames[:n].copy()

    def close(self):
        if self._h is not None:
            self._lib.dsr_loader_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
