"""PyTorch/CUDA port of :mod:`deepinteract_tpu`.

The module layout mirrors the JAX package so that each module's
counterpart is easy to find. The package imports ``torch`` and numpy and
never imports ``jax`` or ``deepinteract_tpu``: the parts it needs from
there (constants, featurization, npz I/O) are kept here as copies.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
see :func:`deepinteract_tpu_torch.device.resolve_device`.
"""
