"""Training: the optimizer and the train step."""
