"""Kernel census of the port's decoder: launches per kernel family.

The port's counterpart of ``deepinteract_tpu/obs/hloquery.py::
decoder_census``. The JAX package counts the ops of a compiled HLO entry
computation; the port has no HLO, so it runs the interaction decoder once
under ``torch.profiler`` and counts what ran: kernels by family
(:func:`~deepinteract_tpu_torch.obs.device.opcode_of`) on the card,
aten ops with time of their own on the CPU. :mod:`deepinteract_tpu_torch.obs.
attribution` joins these counts against measured per-family time.
"""

from __future__ import annotations

import tempfile
from collections import Counter
from typing import Dict, Tuple


def decoder_census(pad: int = 128, masked: bool = True, decoder_cfg=None,
                   device="cuda") -> Tuple[Counter, Dict]:
    """One decoder forward at ``pad`` x ``pad`` (seeded weights and input,
    the JAX census's mask) on ``device``, after one warm forward so that
    lazy initialisation and cuDNN's algorithm search stay out of the
    count. Returns (census, meta); meta records the device and shape."""
    import numpy as np
    import torch

    from deepinteract_tpu_torch.device import resolve_device
    from deepinteract_tpu_torch.models.decoder import DecoderConfig, InteractionDecoder
    from deepinteract_tpu_torch.obs.device import capture, load_profile, opcode_of

    dev = resolve_device(device)
    cfg = decoder_cfg or DecoderConfig()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(
        rng.standard_normal((1, pad, pad, cfg.in_channels)).astype(np.float32)).to(dev)
    mask = torch.ones((1, pad, pad), dtype=torch.bool)
    if masked:
        mask.zero_()
        mask[:, : max(1, pad - 20), : max(1, pad - 28)] = True
    mask = mask.to(dev)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = InteractionDecoder(cfg).to(dev).eval()
    with torch.no_grad():
        model(x, mask)
        with tempfile.TemporaryDirectory(prefix="decoder_census_") as tmp:
            with capture(tmp, dev, annotate_spans=False):
                model(x, mask)
            trace = load_profile(tmp)
    census = Counter(opcode_of(op.name) for op in trace.ops)
    meta = {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "pad": int(pad),
        "masked": bool(masked),
        "source": "decoder_forward",
    }
    return census, meta
