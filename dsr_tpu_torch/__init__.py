"""dsr_tpu_torch: the PyTorch/CUDA port of dsr_tpu's subband front end.

Analysis filterbank, fixed (DS / superdirective MVDR) beamformers,
synthesis, subband MFCC + CMN and diagonal-GMM scoring, with hand-written
Hopper kernels for the filterbank (`ops/cuda/`).  Entry points run on the
card unless the caller passes `device="cpu"`.  Imports torch and numpy
only: never JAX, `dsr_tpu` or `golden`.
"""
