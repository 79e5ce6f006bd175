"""Training: objective, optimizer, train/eval steps, metrics and the loop."""
