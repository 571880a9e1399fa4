"""Speaker adaptation (PyTorch): MLLR mean transforms, fMLLR (CMLLR)
feature transforms, speaker-adaptive training and VTLN warp estimation —
the port's copy of `dsr_tpu/asr/adapt/`."""
