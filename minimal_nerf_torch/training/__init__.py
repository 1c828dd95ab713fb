"""Training configuration, checkpoints and (for now) inference-time loading."""
