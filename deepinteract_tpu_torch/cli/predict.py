"""Predict CLI: one featurized complex ``.npz`` -> contact map.

Port of ``deepinteract_tpu/cli/predict.py`` for ``--input_npz``. Writes

* ``contact_prob_map.npy``      — [n1, n2] positive-class softmax map
* ``graph1_node_feats.npy`` / ``graph2_node_feats.npy``
* ``graph1_edge_feats.npy`` / ``graph2_edge_feats.npy``

into ``--output_dir``. ``--weights`` takes a flat-path ``.npz`` of JAX
variables (``weights.save_npz``); without it the model gets the port's
seeded init. Runs on the GPU unless ``--device cpu`` is given.

    python -m deepinteract_tpu_torch.cli.predict --input_npz X --output_dir Y \
        [--weights W.npz] [--device cpu]
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Optional

import numpy as np
import torch

from deepinteract_tpu_torch.cli.args import build_parser, model_config_from_args
from deepinteract_tpu_torch.data.graph import stack_complexes
from deepinteract_tpu_torch.data.io import load_complex_npz, to_paired_complex
from deepinteract_tpu_torch.device import resolve_device
from deepinteract_tpu_torch.models.model import DeepInteract, ModelConfig
from deepinteract_tpu_torch.models.policy import set_backend_precision
from deepinteract_tpu_torch.weights import init_weights, load_jax_variables, load_npz

REPRESENTATIONS = ("graph1_node_feats", "graph2_node_feats",
                   "graph1_edge_feats", "graph2_edge_feats")


def load_model(cfg: ModelConfig, device, weights: Optional[str] = None,
               seed: int = 42) -> DeepInteract:
    """An eval-mode model on ``device``: JAX variables from a flat-path
    ``.npz`` when ``weights`` is given, else the seeded init."""
    model = DeepInteract(cfg)
    if weights:
        load_jax_variables(model, load_npz(weights))
    else:
        init_weights(model, seed)
    return model.to(device).eval()


@torch.inference_mode()
def predict_complex(raw: Dict, model: DeepInteract, device) -> Dict[str, np.ndarray]:
    """Predict one raw complex (``data.io.load_complex_npz``'s dict).

    Returns float32 numpy arrays: ``contact_prob_map`` [n1, n2], ``logits``
    [n1, n2, 2], and the four representations, depadded (node feats
    [n, C], edge feats [n, K, C]). The model is put in eval mode."""
    device = resolve_device(device)
    model.eval()
    set_backend_precision(model.cfg.gnn.compute_dtype)
    n1 = raw["graph1"]["node_feats"].shape[0]
    n2 = raw["graph2"]["node_feats"].shape[0]
    batch = stack_complexes([to_paired_complex(raw)]).to(device)
    logits, reps = model(batch.graph1, batch.graph2, return_representations=True)
    logits = logits[0, :n1, :n2].float()
    out = {"logits": logits.cpu().numpy(),
           "contact_prob_map": torch.softmax(logits, dim=-1)[..., 1].cpu().numpy()}
    for name in REPRESENTATIONS:
        n = n1 if name.startswith("graph1") else n2
        out[name] = reps[name][0, :n].float().cpu().numpy()
    return out


def main(argv=None) -> int:
    parser = build_parser(__doc__)
    parser.add_argument("--input_npz", type=str, required=True,
                        help="complex .npz (see deepinteract_tpu_torch.data.io)")
    parser.add_argument("--output_dir", type=str, default=".")
    parser.add_argument("--weights", type=str, default=None,
                        help="flat-path .npz of JAX variables (weights.save_npz)")
    args = parser.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        print(f"predict: {err}", file=sys.stderr)
        return 2

    model = load_model(model_config_from_args(args), device, args.weights, args.seed)
    out = predict_complex(load_complex_npz(args.input_npz), model, device)
    os.makedirs(args.output_dir, exist_ok=True)
    saved = []
    for name in ("contact_prob_map",) + REPRESENTATIONS:
        path = os.path.join(args.output_dir, f"{name}.npy")
        np.save(path, out[name])
        saved.append(path)
    print("saved:", ", ".join(saved))
    return 0


if __name__ == "__main__":
    sys.exit(main())
