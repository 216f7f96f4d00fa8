"""Training: optimizer and schedule, the dual-encoder train step."""
