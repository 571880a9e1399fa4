"""Neural models (PyTorch): Conformer-CTC, its streaming form, the learned
mask-MVDR beamformer and their joint training — BASELINE.json config 5."""
