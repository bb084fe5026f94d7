"""The training step (single device so far)."""
