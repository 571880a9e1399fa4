"""Shared helpers of the port's parity tests (tests/test_torch_*.py): the
relative error they gate on and the filterbank and array cases they feed to
both `dsr_tpu` and `dsr_tpu_torch`.  Inputs are made with numpy from a seed.

The parity tests are split into files of at most five tests each so that,
under `pytest -n N --dist loadfile` (which hands out files with more tests
first), they are scheduled after the JAX package's larger files and leave
those files' timing as it was.
"""

import numpy as np
import torch

from dsr_tpu.config import ArrayGeometry as JGeometry
from dsr_tpu.config import FilterbankConfig as JFilterbankConfig
from dsr_tpu.ops import filterbank as jfb
from dsr_tpu_torch.config import ArrayGeometry, FilterbankConfig
from golden import room as groom

torch.set_num_threads(2)

SR = 16000.0
M = 256


def rel(a, ref) -> float:
    """max |a - ref| relative to the largest magnitude of `ref`."""
    a, ref = np.asarray(a), np.asarray(ref)
    assert a.shape == ref.shape
    return float(np.max(np.abs(a - ref)) / np.max(np.abs(ref)))


def filterbank_case(M):
    """(port cfg, JAX cfg, hf, gf, delay): the shipped M=256 prototypes (D=128,
    the TPU's v5 kernels) or random ones at M=512 (D=256, its general kernels)."""
    cfg, jcfg = FilterbankConfig(M=M, m=4, r=2), JFilterbankConfig(M=M, m=4, r=2)
    if M == 256:
        hf, gf, delay = jfb.get_prototypes(jcfg)
    else:
        rng = np.random.default_rng(5)
        hf = rng.standard_normal(cfg.L).astype(np.float32) / 16
        gf = rng.standard_normal(cfg.L).astype(np.float32) / 16
        delay = 0
    return cfg, jcfg, hf, gf, delay


def geometry(n=8, radius=0.10):
    """Circular array positions (equal in both packages) and the steering
    delays, in seconds, towards a source 2 m in front of it."""
    POS = np.asarray(ArrayGeometry.circular(n, radius).positions)
    assert np.array_equal(POS, np.asarray(JGeometry.circular(n, radius).positions))
    taus = (groom.steering_delays(POS, np.array([0.0, 2.0, 0.0]), 343.0, SR) / SR)
    return POS, taus.astype(np.float32)


def subbands(rng, N=8, T=40, K=M // 2 + 1):
    return (rng.standard_normal((N, T, K)) + 1j * rng.standard_normal((N, T, K))).astype(
        np.complex64
    )
