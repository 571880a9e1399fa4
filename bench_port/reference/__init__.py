"""Plain references: straightforward PyTorch of the same semantics as the
timed path, importing nothing of the port and taking nothing it made."""
