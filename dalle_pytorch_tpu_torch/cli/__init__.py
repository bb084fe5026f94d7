"""What the training entry points share: per-step keys, the learning-rate
schedule, the optimizer and the EMA."""
