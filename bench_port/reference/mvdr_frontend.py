"""Plain reference of the MVDR front-end cell: superdirective MVDR
weights, the oversampled DFT filterbank's analysis and synthesis, subband
MFCC with CMN, and diagonal-GMM log-likelihoods.

Written from the definitions, in float64 (complex128), on whatever device
it is given:

- steering v_kn = exp(-2 pi j f_k tau_n), f_k = k fs / M, tau_n = (|p_n - s|
  - |s|) / c; diffuse coherence sinc(2 pi f d_nm / c) plus `loading` on
  the diagonal; w_k = G^-1 v_k / (v_k^H G^-1 v_k), by a solve;
- analysis: the signal padded by L - D samples in front (L = m M taps,
  hop D = M / r), frame t the L samples from t D, times the analysis
  prototype, folded to M samples by summing its m segments, and a real
  DFT: bins 0 .. M / 2; the beamformer's output sum_n conj(w_kn) A_ntk;
- synthesis: each frame's inverse real DFT of length M, repeated to L
  samples times the synthesis prototype, overlap-added at hop D, and the
  samples from L - D + delay on (clamped so the block fits);
- features: |Y|^2 through triangular mel filters (centres equally spaced
  on 2595 log10(1 + f / 700) from fmin to fs / 2), the log (floor 1e-10),
  an orthonormal DCT-II, then the mean over frames subtracted;
- the GMM as in `reference/lvcsr_decode.gmm_loglik`.

The prototypes are the shipped `.npz` file, read directly.

`precision` "float64" is the reference.  "control" is the same code a
step below the configuration's float32: every stage's inputs and outputs
rounded to bfloat16 (the arithmetic in float32), and the matrix products'
inputs rounded to TF32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bench_port.reference.lvcsr_decode import gmm_loglik, tf32


def _mel(num_mel: int, freqs: np.ndarray, fmin: float, fmax: float) -> np.ndarray:
    mel = lambda f: 2595.0 * np.log10(1.0 + f / 700.0)             # noqa: E731
    imel = lambda m: 700.0 * (10.0 ** (m / 2595.0) - 1.0)          # noqa: E731
    c = imel(np.linspace(mel(fmin), mel(fmax), num_mel + 2))
    up = (freqs[None, :] - c[:-2, None]) / np.maximum(c[1:-1] - c[:-2], 1e-10)[:, None]
    down = (c[2:, None] - freqs[None, :]) / np.maximum(c[2:] - c[1:-1], 1e-10)[:, None]
    return np.maximum(0.0, np.minimum(up, down))


def _dct(num_cep: int, num_mel: int) -> np.ndarray:
    n = np.arange(num_mel)[None, :]
    k = np.arange(num_cep)[:, None]
    C = np.cos(np.pi * k * (2 * n + 1) / (2 * num_mel)) * np.sqrt(2.0 / num_mel)
    C[0] *= np.sqrt(0.5)
    return C


class Frontend:
    """The cell's configuration, in the reference's own tables."""

    def __init__(self, config: dict, prototype_file: str, mics: np.ndarray, device,
                 precision: str = "float64"):
        fbc, fe = config["filterbank"], config["frontend"]
        self.M, self.m, self.r = fbc["M"], fbc["m"], fbc["r"]
        self.L, self.D, self.K = self.m * self.M, self.M // self.r, self.M // 2 + 1
        self.fs = float(config["sample_rate"])
        self.c = config["array"]["sound_speed"]
        self.loading = config["beamformer"]["diagonal_loading"]
        self.low = precision != "float64"
        self.rdt = torch.float32 if self.low else torch.float64
        self.cdt = torch.complex64 if self.low else torch.complex128
        self.dev = device
        with np.load(prototype_file) as z:
            self.hf = torch.as_tensor(z["hf"], dtype=self.rdt, device=device)
            self.gf = torch.as_tensor(z["gf"], dtype=self.rdt, device=device)
            self.delay = int(z["delay"])
        self.mics = torch.as_tensor(mics, dtype=torch.float64, device=device)
        self.freqs = torch.arange(self.K, dtype=torch.float64, device=device) * self.fs / self.M
        fmax = fe.get("fmax") or self.fs / 2
        self.mel = torch.as_tensor(_mel(fe["num_mel"], self.freqs.cpu().numpy(), fe["fmin"],
                                        fmax), dtype=self.rdt, device=device)
        self.dct = torch.as_tensor(_dct(fe["num_cepstra"], fe["num_mel"]), dtype=self.rdt,
                                   device=device)
        d = torch.linalg.norm(self.mics[:, None] - self.mics[None], dim=-1)
        x = 2 * math.pi * self.freqs[:, None, None] * d[None] / self.c
        gamma = torch.where(x == 0, 1.0, torch.sin(x) / torch.where(x == 0, 1.0, x))
        N = len(mics)
        self.gamma = (gamma + self.loading * torch.eye(N, dtype=torch.float64, device=device)
                      ).to(torch.complex128)

    def rnd(self, x: torch.Tensor) -> torch.Tensor:
        """bfloat16 rounding in the control, nothing in the reference."""
        if not self.low:
            return x
        if x.is_complex():
            return torch.complex(self.rnd(x.real), self.rnd(x.imag))
        return x.to(torch.bfloat16).to(x.dtype)

    def weights(self, talker: np.ndarray) -> torch.Tensor:
        """(K, N) MVDR weights towards a talker position (3,)."""
        s = torch.as_tensor(talker, dtype=torch.float64, device=self.dev)
        tau = (torch.linalg.norm(self.mics - s, dim=-1) - torch.linalg.norm(s)) / self.c
        ph = -2 * math.pi * self.freqs[:, None] * tau[None, :]
        v = torch.complex(torch.cos(ph), torch.sin(ph))
        if self.low:
            g = self.rnd(self.gamma.to(torch.complex64))
            gv = self.rnd(torch.linalg.solve(g, self.rnd(v.to(torch.complex64))[..., None])[..., 0])
            return self.rnd(gv / (v.to(torch.complex64).conj() * gv).sum(-1, keepdim=True))
        gv = torch.linalg.solve(self.gamma, v[..., None])[..., 0]
        return gv / (v.conj() * gv).sum(-1, keepdim=True)

    def analysis(self, x: torch.Tensor) -> torch.Tensor:
        """(N, S) -> (N, T, K) subbands."""
        S = x.shape[-1]
        T = -(-(S + (self.L - self.D) + self.L) // self.D)
        x = self.rnd(x.to(self.rdt))
        xp = torch.nn.functional.pad(x, (self.L - self.D, (T - 1) * self.D + self.D - S))
        fr = xp.unfold(-1, self.L, self.D) * self.rnd(self.hf)           # (N, T, L)
        u = fr.reshape(*fr.shape[:-1], self.m, self.M).sum(-2)
        return self.rnd(torch.fft.rfft(u, dim=-1))

    def beamform(self, A: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.rnd(torch.einsum("kn,ntk->tk", w.to(A.dtype).conj(), A))

    def synthesis(self, Y: torch.Tensor, S: int) -> torch.Tensor:
        """(T, K) -> (S,) samples."""
        T = Y.shape[0]
        v = torch.fft.irfft(self.rnd(Y), n=self.M, dim=-1)                # (T, M)
        fr = v.repeat(1, self.m) * self.rnd(self.gf)                      # (T, L)
        n = (T - 1) * self.D + self.L
        y = torch.zeros(n, dtype=fr.dtype, device=fr.device)
        idx = (torch.arange(T, device=fr.device)[:, None] * self.D
               + torch.arange(self.L, device=fr.device)).reshape(-1)
        y.index_add_(0, idx, fr.reshape(-1))
        start = min(max(self.L - self.D + self.delay, 0), n - S)
        return self.rnd(y[start:start + S])

    def features(self, Y: torch.Tensor) -> torch.Tensor:
        """(T, K) -> (T, num_cepstra) cepstra after CMN."""
        P = self.rnd(Y.real**2 + Y.imag**2)
        r = tf32 if self.low else (lambda t: t)
        e = torch.log(torch.clamp_min(r(P) @ r(self.mel).T, 1e-10))
        c = r(self.rnd(e)) @ r(self.dct).T
        return self.rnd(c - c.mean(dim=0, keepdim=True))

    def loglik(self, feats, means, variances, logw) -> torch.Tensor:
        return gmm_loglik(feats, means, variances, logw,
                          "control" if self.low else "float64")
