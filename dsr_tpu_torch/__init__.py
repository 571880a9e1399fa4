"""dsr_tpu_torch: the PyTorch/CUDA port of dsr_tpu.

The subband front end (analysis filterbank, fixed DS / superdirective MVDR
beamformers, synthesis, subband MFCC + CMN, diagonal-GMM scoring) and the
LVCSR decode (the HCLG build with the port's own WFST core, dense and
degree-split batched top-K token passing, traceback, streaming
recognition), with hand-written Hopper kernels for the filterbank and for
the decoders' per-frame select (`ops/cuda/`).  Entry points run on the card
unless the caller passes `device="cpu"`.  Imports torch and numpy only:
never JAX, `dsr_tpu` or `golden`.
"""
