"""The synthesis kernel as an inverse real FFT (`dsr_tpu_torch/ops/cuda/
csrc/filterbank.cu`) transcribed to NumPy on the CPU (`_torch_parity`'s
synthesis_idft, synthesis_plan, synthesis_tiles and synthesis_device_route:
the pack of the K bins into n complex points with the DC and Nyquist
imaginary parts dropped, the radix-8 Stockham plan of `csrc/fft.cuh` run on
the conjugate, the unpack, the tiles with their halo of m r - 1 frames and
the gather, and the route through device memory), held to the plain twin
`synthesis_plain` and to the JAX package's synthesis (its XLA path on the
CPU); and the build's hash over the headers a source includes.

Tolerance: 1e-5 of the largest magnitude, as tests/test_torch_filterbank.py:
the transcription, the twin and the JAX path differ only in float32 FFT
rounding.
"""

import numpy as np
import pytest
import torch

from _torch_parity import (rel, synthesis_device_route, synthesis_plan, synthesis_tiles)
from dsr_tpu.config import FilterbankConfig as JFilterbankConfig
from dsr_tpu.ops import filterbank as jfb
from dsr_tpu_torch.ops.cuda import build
from dsr_tpu_torch.ops.cuda import filterbank as cfb

TOL = 1e-5


@pytest.mark.parametrize("M,m,r,T", [(256, 4, 2, 40), (512, 4, 2, 20), (96, 2, 2, 30),
                                     (127, 2, 1, 12), (256, 8, 32, 120)])
def test_synthesis_fft_in_numpy_matches_plain_and_jax(M, m, r, T):
    """Random spectra of 2 channels with non-zero imaginary parts at DC and
    Nyquist, random gf, the output from delay 5 (start = L - D + 5), to the
    end of the stream less 3 samples.  The route the plan takes on an H100
    (tiles of F frames, or through device memory at M = 256 m = 8 r = 32),
    and the tiles also at F = 5 (several frames a tile, a ragged last one)."""
    rng = np.random.default_rng(M + m + r)
    D, K, L = M // r, M // 2 + 1, m * M
    A = (rng.standard_normal((2, T, K)) + 1j * rng.standard_normal((2, T, K))).astype(np.complex64)
    assert np.all(A[..., 0].imag != 0) and (M % 2 or np.all(A[..., -1].imag != 0))
    gf = rng.standard_normal(L).astype(np.float32) / 16
    delay = 5
    start = L - D + delay
    out_len = (T - 1) * D + L - start - 3
    ref = cfb.synthesis_plain(torch.as_tensor(A), torch.as_tensor(gf), M, r, start,
                              out_len).numpy()
    y_jax = np.asarray(jfb.synthesis(A, JFilterbankConfig(M=M, m=m, r=r), out_len, gf, delay))
    assert rel(ref, y_jax) < TOL
    plan = synthesis_plan(2, M, m, r, start, out_len)
    assert plan[0] == ("device" if (M, m, r) == (256, 8, 32) else "tiles")
    if plan[0] == "tiles":
        for F in (plan[1], 5):
            y = synthesis_tiles(A, gf, M, m, r, start, out_len, F)
            assert rel(y, ref) < TOL and rel(y, y_jax) < TOL, F
    else:
        y = synthesis_device_route(A, gf, M, m, r, start, out_len, *plan[1:])
        assert rel(y, ref) < TOL and rel(y, y_jax) < TOL


def test_synthesis_plan_routes_at_the_configs_the_card_runs():
    """On an H100 (132 SMs, 227 KB of shared memory a block): the serving
    output (1 ch x 8 s at M = 256 m = 4 r = 2) in tiles of 8 frames (126
    blocks, each transforming 15 frames), 8 ch x 4 s in tiles of 25 (the
    4,096-point cap: 32 frames of 128 points less the halo); the
    configs above the old kernel's shared-memory opt-in (M = 512 r = 4, 1024
    r = 2, 768 r = 1 and 2) in tiles; M = 256 m = 8 r = 32 (m r = 256
    frames a sample), M = 4096 m = 8 r = 4096 and M = 32,768 (its FFT alone
    above a block's two buffers) through device memory."""
    def route(C, M, m, r, S):
        return synthesis_plan(C, M, m, r, m * M - M // r, S)

    assert route(1, 256, 4, 2, 128000) == ("tiles", 8)
    assert route(8, 256, 4, 2, 64000) == ("tiles", 25)
    for M, r in ((512, 4), (1024, 2), (768, 1), (768, 2)):
        assert route(4, M, 4, r, 16000)[0] == "tiles", (M, r)
    assert route(2, 256, 8, 32, 8000)[0] == "device"
    assert route(1, 4096, 8, 4096, 2000) == ("device", 0, 34767)
    assert route(1, 32768, 2, 2, 128000)[0] == "device"


def test_build_target_covers_included_headers(tmp_path, monkeypatch):
    """The library's name hashes the source and the headers it includes by
    `#include "..."` (recursively): editing a header renames it, so a stale
    build is never loaded; an unrelated file does not."""
    src, hdr, sub = tmp_path / "k.cu", tmp_path / "fft.cuh", tmp_path / "more.cuh"
    src.write_text('#include <cuda_runtime.h>\n#include "fft.cuh"\nint f() { return g(); }\n')
    hdr.write_text('#include "more.cuh"\ninline int g() { return h(); }\n')
    sub.write_text("inline int h() { return 1; }\n")
    (tmp_path / "other.cuh").write_text("// not included\n")
    monkeypatch.setitem(build.SOURCES, "probe", (src, "nvcc"))
    assert [p.name for p in build.sources_of(src)] == ["k.cu", "fft.cuh", "more.cuh"]
    first = build.target("probe")
    (tmp_path / "other.cuh").write_text("// still not included\n")
    assert build.target("probe") == first
    sub.write_text("inline int h() { return 2; }\n")
    second = build.target("probe")
    assert second != first
    hdr.write_text('#include "more.cuh"\ninline int g() { return h() + 1; }\n')
    assert build.target("probe") not in (first, second)
    assert [p.name for p in build.sources_of(build.SOURCES["analysis"][0])] == [
        "analysis.cu", "fft.cuh"]
    assert [p.name for p in build.sources_of(build.SOURCES["filterbank"][0])] == [
        "filterbank.cu", "fft.cuh"]
