"""Encoder, decoder and full-model modules as ``torch.nn.Module``s."""
