"""Training: configuration, the train step, checkpoints and inference-time loading."""
