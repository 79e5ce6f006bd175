"""Edge attention: the plain PyTorch op and the hand-written CUDA kernel."""
