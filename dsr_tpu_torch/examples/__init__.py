"""The port's examples, one script each, run as
`python -m dsr_tpu_torch.examples.<name>`; each has `main(..., device=None)`
and runs on the card unless `device="cpu"`."""
