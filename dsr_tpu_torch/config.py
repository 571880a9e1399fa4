"""Typed configuration for the PyTorch port: the front end and the device mesh.

A copy of the front-end and mesh dataclasses of `dsr_tpu/config.py` (same
fields, defaults and derived properties) and of its JSON helpers, kept here
so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class FilterbankConfig:
    """Oversampled DFT filterbank: M subbands, prototype length m*M, D = M/r."""

    M: int = 256
    m: int = 4
    r: int = 2
    rolloff: float = 1.0
    joint_iters: int = 2

    def __post_init__(self):
        if self.M % self.r != 0:
            raise ValueError(f"r={self.r} must divide M={self.M}")

    @property
    def L(self) -> int:
        return self.m * self.M

    @property
    def D(self) -> int:
        return self.M // self.r

    @property
    def num_bins(self) -> int:
        return self.M // 2 + 1


@dataclass(frozen=True)
class ArrayGeometry:
    """Microphone array geometry; positions in metres, shape (N, 3)."""

    positions: tuple[tuple[float, float, float], ...]
    sound_speed: float = 343.0

    @property
    def num_channels(self) -> int:
        return len(self.positions)

    @staticmethod
    def linear(n: int, spacing: float, sound_speed: float = 343.0) -> "ArrayGeometry":
        half = (n - 1) / 2.0
        return ArrayGeometry(
            tuple((float((i - half) * spacing), 0.0, 0.0) for i in range(n)),
            sound_speed,
        )

    @staticmethod
    def circular(n: int, radius: float, sound_speed: float = 343.0) -> "ArrayGeometry":
        return ArrayGeometry(
            tuple(
                (
                    radius * math.cos(2 * math.pi * i / n),
                    radius * math.sin(2 * math.pi * i / n),
                    0.0,
                )
                for i in range(n)
            ),
            sound_speed,
        )


@dataclass(frozen=True)
class BeamformerConfig:
    """kind ∈ {'ds', 'mvdr', 'gsc'} (delay-and-sum / superdirective / GSC)."""

    kind: str = "ds"
    diagonal_loading: float = 1e-2  # MVDR: Γ + λI
    mu: float = 0.1                 # GSC NLMS step size
    eps: float = 1e-6               # GSC NLMS regulariser
    wa_norm_cap: float = 10.0       # GSC active-weight norm constraint


@dataclass(frozen=True)
class FrontendConfig:
    """ASR feature front end (MFCC by default)."""

    sample_rate: int = 16000
    num_mel: int = 30
    num_cepstra: int = 13
    fmin: float = 20.0
    fmax: float | None = None
    preemphasis: float = 0.97
    frame_len: int = 400   # only used by the time-domain (non-subband) path
    frame_hop: int = 160
    delta_window: int = 2
    cmn: bool = True
    vtln_warp: float = 1.0


@dataclass(frozen=True)
class MeshConfig:
    """Logical device mesh: data (utterance batch), model (AM/graph shards),
    subband (sequence-parallel axis over the M filterbank bins)."""

    data: int = 1
    model: int = 1
    subband: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.model * self.subband


def to_json(cfg: Any) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2)


def from_json(cls, s: str):
    return cls(**json.loads(s))
