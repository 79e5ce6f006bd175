"""Predict CLI: one complex -> contact map.

Port of ``deepinteract_tpu/cli/predict.py``. The complex is either a
featurized ``.npz`` (``--input_npz``) or two PDB files (``--left_pdb`` and
``--right_pdb``), featurized on the host by
:mod:`deepinteract_tpu_torch.pipeline` (without labels, as the JAX CLI
does; ``--save_npz`` also writes the featurized complex). Writes

* ``contact_prob_map.npy``      — [n1, n2] positive-class softmax map
* ``graph1_node_feats.npy`` / ``graph2_node_feats.npy``
* ``graph1_edge_feats.npy`` / ``graph2_edge_feats.npy`` (not with the GCN
  encoder, which learns no edge features)

into ``--output_dir``; with ``--top_k K`` also ``top_contacts.json``, the
K most probable contacts ranked by ``screening.scoring.pair_summary`` (the
helper bulk screening ranks with), and a last stdout line that is the
``predict_topk`` contract (``tools/check_cli_contract.py``);
``--calibration`` adds calibrated probabilities next to the raw ones
(a fitted artifact of ``cli.calibrate``, refused when it was fitted for
other weights). ``--weights`` takes a flat-path ``.npz`` of JAX
variables (``weights.save_npz``); ``--ckpt_name`` a checkpoint directory
of the port's trainer, whose best/ step is restored; with neither the
model gets the port's seeded init. ``--input_indep`` zeroes every input
feature first (the reference's control). Runs on the GPU unless
``--device cpu`` is given.

    python -m deepinteract_tpu_torch.cli.predict \
        (--input_npz X | --left_pdb L --right_pdb R [--save_npz C]) --output_dir Y \
        [--weights W.npz | --ckpt_name DIR] [--top_k 10 [--calibration C.json]] \
        [--input_indep] [--device cpu]
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from deepinteract_tpu_torch.cli.args import (add_calibration_args, add_restore_args,
                                             build_parser, model_config_from_args)
from deepinteract_tpu_torch.data.graph import stack_complexes
from deepinteract_tpu_torch.data.io import load_complex_npz, to_paired_complex
from deepinteract_tpu_torch.device import resolve_device
from deepinteract_tpu_torch.models.model import DeepInteract, ModelConfig
from deepinteract_tpu_torch.models.policy import set_backend_precision
from deepinteract_tpu_torch.training.checkpoint import CheckpointConfig, Checkpointer
from deepinteract_tpu_torch.weights import (carried_signature, init_weights, load_jax_variables,
                                            load_npz, seeded_signature)

REPRESENTATIONS = ("graph1_node_feats", "graph2_node_feats",
                   "graph1_edge_feats", "graph2_edge_feats")


def load_model(cfg: ModelConfig, device, weights: Union[str, Mapping, None] = None,
               seed: int = 42, ckpt_name: Optional[str] = None,
               metric_to_track: str = "val_ce") -> DeepInteract:
    """An eval-mode model on ``device``: JAX variables from a flat-path
    ``.npz`` or a ``{"params", "batch_stats"}`` tree (``weights``), or the
    best/ step of a checkpoint directory (``ckpt_name``, ranked by
    ``metric_to_track``), else the seeded init."""
    if weights and ckpt_name:
        raise ValueError("give --weights or --ckpt_name, not both")
    model = DeepInteract(cfg)
    if isinstance(weights, Mapping):
        load_jax_variables(model, weights)
    elif weights:
        load_jax_variables(model, load_npz(weights))
    elif ckpt_name:
        model.to(device)
        Checkpointer(CheckpointConfig(directory=ckpt_name, metric_to_track=metric_to_track)
                     ).restore(model, which="best", partial=True)
    else:
        init_weights(model, seed)
    return model.to(device).eval()


@torch.inference_mode()
def predict_complex(raw: Dict, model: DeepInteract, device,
                    input_indep: bool = False) -> Dict[str, np.ndarray]:
    """Predict one raw complex (``data.io.load_complex_npz``'s dict);
    ``input_indep`` zeroes its input features first.

    Returns float32 numpy arrays: ``contact_prob_map`` [n1, n2], ``logits``
    [n1, n2, 2], and the representations the encoder gives, depadded (node
    feats [n, C], edge feats [n, K, C]; no edge feats from the GCN). The
    model is put in eval mode."""
    device = resolve_device(device)
    model.eval()
    set_backend_precision(model.cfg.gnn.compute_dtype)
    n1 = raw["graph1"]["node_feats"].shape[0]
    n2 = raw["graph2"]["node_feats"].shape[0]
    batch = stack_complexes([to_paired_complex(raw, input_indep=input_indep)]).to(device)
    logits, reps = model(batch.graph1, batch.graph2, return_representations=True)
    logits = logits[0, :n1, :n2].float()
    out = {"logits": logits.cpu().numpy(),
           "contact_prob_map": torch.softmax(logits, dim=-1)[..., 1].cpu().numpy()}
    for name in REPRESENTATIONS:
        if reps[name] is not None:
            n = n1 if name.startswith("graph1") else n2
            out[name] = reps[name][0, :n].float().cpu().numpy()
    return out


def main(argv=None) -> int:
    parser = build_parser(__doc__)
    parser.add_argument("--input_npz", type=str, default=None,
                        help="complex .npz (see deepinteract_tpu_torch.data.io)")
    parser.add_argument("--left_pdb", type=str, default=None,
                        help="left chain PDB (featurized by the pipeline)")
    parser.add_argument("--right_pdb", type=str, default=None)
    parser.add_argument("--save_npz", type=str, default=None,
                        help="also persist the featurized complex here")
    parser.add_argument("--output_dir", type=str, default=".")
    parser.add_argument("--weights", type=str, default=None,
                        help="flat-path .npz of JAX variables (weights.save_npz)")
    parser.add_argument("--top_k", type=int, default=0,
                        help="also rank the K most probable contacts (screening.scoring."
                             "pair_summary, as bulk screening ranks): writes "
                             "top_contacts.json and makes the last stdout line a "
                             "machine-readable JSON summary")
    parser.add_argument("--input_indep", action="store_true",
                        help="zero all input features (the reference's control)")
    add_restore_args(parser)
    add_calibration_args(parser)
    args = parser.parse_args(argv)
    if not args.input_npz and not (args.left_pdb and args.right_pdb):
        parser.error("provide --input_npz or both --left_pdb and --right_pdb")
    if args.weights and args.ckpt_name:
        parser.error("give --weights or --ckpt_name, not both")
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        print(f"predict: {err}", file=sys.stderr)
        return 2

    model = load_model(model_config_from_args(args), device, args.weights, args.seed,
                       args.ckpt_name, args.metric_to_track)
    cal = None
    if args.calibration:
        # Verified before any prediction, against the engine's
        # weights_signature for the same flags (a digest of the loaded
        # state for --weights).
        from deepinteract_tpu_torch.calibration import load_calibration

        cal = load_calibration(
            args.calibration,
            expect_signature=args.ckpt_name or (
                carried_signature(model) if args.weights else seeded_signature(args.seed)),
            allow_stale=args.allow_stale_calibration)
    out = predict_complex(load_input(args), model, device, input_indep=args.input_indep)
    os.makedirs(args.output_dir, exist_ok=True)
    saved = []
    for name in ("contact_prob_map",) + REPRESENTATIONS:
        if name not in out:
            continue
        path = os.path.join(args.output_dir, f"{name}.npy")
        np.save(path, out[name])
        saved.append(path)
    print("saved:", ", ".join(saved))
    if args.top_k > 0:
        write_top_contacts(args, out, cal)
    return 0


def load_input(args) -> Dict:
    """The raw complex of ``--input_npz``, else the featurized PDB pair
    (saved to ``--save_npz`` when given)."""
    if args.input_npz:
        return load_complex_npz(args.input_npz)
    from deepinteract_tpu_torch.pipeline.pair import convert_pdb_pair_to_complex

    return convert_pdb_pair_to_complex(args.left_pdb, args.right_pdb,
                                       output_npz=args.save_npz, with_labels=False)


def write_top_contacts(args, out: Dict[str, np.ndarray], cal) -> None:
    """``top_contacts.json`` and the ``predict_topk`` contract line."""
    import json

    from deepinteract_tpu_torch.robustness import artifacts
    from deepinteract_tpu_torch.screening.scoring import pair_summary

    probs = out["contact_prob_map"]
    summary = pair_summary(probs, args.top_k)
    if cal is not None:
        # Calibrated probabilities ride NEXT TO the raw ones: the raw
        # score / max_prob / p keys never change meaning.
        ps = np.asarray([c["p"] for c in summary["top_contacts"]], dtype=np.float64)
        cal_ps = cal.apply(ps)
        for c, p_cal in zip(summary["top_contacts"], cal_ps):
            c["p_cal"] = round(float(p_cal), 6)
        summary["calibrated_score"] = round(float(cal_ps.mean()), 6)
        summary["calibration"] = args.calibration
    contacts_path = os.path.join(args.output_dir, "top_contacts.json")
    artifacts.atomic_write(contacts_path, json.dumps(summary, indent=1))
    line = {
        "metric": "pair_score_topk_mean",
        "value": round(summary["score"], 6),
        "unit": "probability",
        "top_k": summary["top_k"],
        "max_prob": round(summary["max_prob"], 6),
        "n1": int(probs.shape[0]), "n2": int(probs.shape[1]),
        "top_contacts_out": contacts_path,
        "contact_map_out": os.path.join(args.output_dir, "contact_prob_map.npy"),
    }
    if cal is not None:
        line["calibrated_score"] = summary["calibrated_score"]
        line["calibration"] = args.calibration
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    sys.exit(main())
