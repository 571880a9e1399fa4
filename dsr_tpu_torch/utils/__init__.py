"""Design-time helpers and device selection."""
