"""WFST algebra and decoding-graph construction (build-time, host).

The port's copy of `dsr_tpu/asr/fsm/`: the `Wfst` structure, its native
C++ core (compose, determinize, rmepsilon), the H/L/G builders, the ARPA
reader and trainer, and the packed arc tables the decoders consume.
"""

from dsr_tpu_torch.asr.fsm.wfst import EPS, Wfst  # noqa: F401
