"""Import a reference (torch/Lightning) checkpoint into the port.

Port of ``deepinteract_tpu/cli/import_checkpoint.py``. The reference
publishes trained weights as a Lightning ``.ckpt`` (Zenodo record
6671582). This CLI converts such a ``.ckpt`` / ``.pt`` / ``.npz`` into a
checkpoint directory of the port's own format (``training/checkpoint.py``)
that ``cli.test``, ``cli.predict --ckpt_name`` and ``cli.train --fine_tune
--ckpt_name`` consume::

    python -m deepinteract_tpu_torch.cli.import_checkpoint \\
        --ckpt LitGINI-GeoTran-DilResNet.ckpt --out_dir imported/geotran

Model hyperparameters come from the Lightning checkpoint's
``hyper_parameters`` when present; explicit flags win. Only the model's
weights and batch statistics are carried (``training/import_torch.py``,
then ``weights.load_jax_variables``): the reference's optimizer state does
not carry over, so training continues with ``--fine_tune``. The importer
takes the Geometric Transformer and the GCN encoders with the dilated
decoder, the published configurations; DeepLab is refused.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def load_reference_checkpoint(path: str, unsafe_load: bool = False):
    """(state dict of numpy arrays, hyperparameters dict) of a checkpoint
    file: a Lightning ``.ckpt`` / torch ``.pt`` (``{"state_dict",
    "hyper_parameters"}`` or a bare state dict) or an ``.npz`` of arrays.

    Checkpoints come from outside, so ``torch.load`` runs with
    ``weights_only=True``, which executes no pickled code. A checkpoint
    whose ``hyper_parameters`` hold other types needs ``unsafe_load``
    (``--unsafe-load``): use it only on files you trust."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            return dict(data), {}
    if unsafe_load:
        print("WARNING: --unsafe-load executes pickled code from the checkpoint; only use "
              "it on files you trust", file=sys.stderr)
        blob = torch.load(path, map_location="cpu", weights_only=False)
    else:
        try:
            blob = torch.load(path, map_location="cpu", weights_only=True)
        except Exception as exc:
            raise SystemExit(f"safe (weights_only) torch.load failed: {exc}\nIf the "
                             "checkpoint stores custom hyper_parameter types, re-run with "
                             "--unsafe-load (trusted files only).")
    if isinstance(blob, dict) and "state_dict" in blob:
        sd, hparams = blob["state_dict"], dict(blob.get("hyper_parameters") or {})
    else:
        sd, hparams = blob, {}
    return {key: value.detach().cpu().numpy() if hasattr(value, "detach")
            else np.asarray(value) for key, value in sd.items()}, hparams


# Reference hyperparameter -> flag of the same name.
_HPARAMS = ("num_gnn_layers", "num_gnn_hidden_channels", "num_gnn_attention_heads",
            "num_interact_layers", "num_interact_hidden_channels", "use_interact_attention",
            "disable_geometric_mode", "dropout_rate")


def apply_hparams(args: argparse.Namespace, hparams: dict,
                  parser: argparse.ArgumentParser, log=print) -> None:
    """Overlay checkpoint hyperparameters onto the parser's defaults: a
    flag is filled from the checkpoint only while it holds its default, so
    explicit flags win."""

    def fill(name, value) -> int:
        if getattr(args, name) == parser.get_default(name):
            setattr(args, name, value)
            return 1
        return 0

    applied = sum(fill(name, hparams[name]) for name in _HPARAMS if name in hparams)
    if "gnn_layer_type" in hparams:
        applied += fill("gnn_layer_type", "gcn" if str(hparams["gnn_layer_type"]).lower()
                        == "gcn" else "geotran")
    if "interact_module_type" in hparams:
        applied += fill("interact_module_type", "deeplab" if str(
            hparams["interact_module_type"]).lower() == "deeplab" else "dilated")
    if applied:
        log(f"applied {applied} checkpoint hyperparameters (of {len(hparams)} in the blob; "
            "explicit flags kept)")


def imported_model(sd, model_cfg, log=print):
    """A CPU model of ``model_cfg`` holding the reference state dict
    ``sd``, converted strictly."""
    from deepinteract_tpu_torch.models.model import DeepInteract
    from deepinteract_tpu_torch.training.import_torch import convert_state_dict
    from deepinteract_tpu_torch.weights import load_jax_variables

    variables, report = convert_state_dict(sd, model_cfg)
    log(report.summary())
    model = DeepInteract(model_cfg)
    load_jax_variables(model, variables)
    return model


def main(argv=None) -> int:
    from deepinteract_tpu_torch.cli.args import build_parser, model_config_from_args
    from deepinteract_tpu_torch.training.checkpoint import CheckpointConfig, Checkpointer

    parser = build_parser(__doc__)
    parser.add_argument("--ckpt", type=str, required=True,
                        help="reference checkpoint file (.ckpt/.pt/.npz)")
    parser.add_argument("--out_dir", type=str, required=True,
                        help="checkpoint directory to create")
    parser.add_argument("--no_hparams", action="store_true",
                        help="ignore the checkpoint's hyper_parameters")
    parser.add_argument("--unsafe-load", action="store_true",
                        help="allow a full (code-executing) pickle load of a checkpoint the "
                             "safe weights_only path rejects; trusted files only")
    args = parser.parse_args(argv)

    sd, hparams = load_reference_checkpoint(args.ckpt, args.unsafe_load)
    if not args.no_hparams:
        apply_hparams(args, hparams, parser)
    if args.interact_module_type != "dilated" or args.gnn_layer_type not in ("geotran", "gcn"):
        raise SystemExit("the importer takes the published configurations: the geotran or "
                         "gcn encoder with the dilated decoder (no DeepLab import)")

    model = imported_model(sd, model_config_from_args(args))
    ckpt = Checkpointer(CheckpointConfig(directory=args.out_dir))
    ckpt.save(0, {"model": {k: v.detach().clone() for k, v in model.state_dict().items()}},
              {"val_ce": 0.0})
    ckpt.close()
    print(f"wrote imported checkpoint to {args.out_dir} (use it with --ckpt_name "
          f"{args.out_dir} in cli.test / cli.predict, or cli.train --fine_tune)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
