"""Torch/Lightning checkpoint importer: reference state dicts -> the JAX
package's variables tree, which ``weights.load_jax_variables`` carries
into the port.

Port of ``deepinteract_tpu/training/import_torch.py`` (numpy only). The
JAX version sizes its target tree with ``jax.eval_shape``; the port
enumerates the same flax paths and shapes from its own model
(:func:`deepinteract_tpu_torch.weights.jax_variable_shapes`, on the meta
device). The rules below are the JAX package's.

The reference ships trained Lightning checkpoints (``README.md:249-253``,
Zenodo 6671582: ``LitGINI-GeoTran-DilResNet.ckpt``) whose ``state_dict``
follows the torch module layout of ``LitGINI``
(``deepinteract_modules.py:1478-1658``):

* ``node_in_embedding`` — input Linear (:1541-1542)
* ``gnn_module.0`` — one ``DGLGeometricTransformer`` (:1595-1625) holding
  ``init_edge_module`` (:128-264) and ``gt_block.{i}`` layers (:500-951)
* ``interact_module`` — ``ResNet2DInputWithOptAttention`` (:1155-1248)

This module maps those tensors onto the flax tree. Transform rules:

* ``nn.Linear.weight`` ``[out, in]``  -> ``Dense.kernel``  ``[in, out]`` (transpose)
* ``nn.Conv2d.weight`` ``[O, I, kh, kw]`` -> ``nn.Conv.kernel`` ``[kh, kw, I, O]``
* ``nn.Embedding.weight``              -> ``Embed.embedding`` (as-is)
* ``BatchNorm1d``: ``weight/bias`` -> params ``scale/bias``;
  ``running_mean/running_var`` -> ``batch_stats`` ``mean/var``;
  ``num_batches_tracked`` dropped.
* ``InstanceNorm2d``/``LayerNorm``: ``weight/bias`` -> ``scale/bias``.

Layout facts that make the mapping exact (verified against the reference):

* Q/K/V are single ``[C, C]`` Linears viewed as ``[heads, C/heads]``
  head-major (``deepinteract_modules.py:48-51,63-66``); the
  ``reshape(b, n, h, d)`` uses the identical memory order, so **no per-head
  split or permutation is required**: a plain transpose suffices.
* ``construct_interact_tensor`` (``deepinteract_utils.py:158-172``)
  concatenates chain-1 channels then chain-2 channels along dim 1
  (``torch.cat((repeat(x_a), repeat(x_b)), dim=1)``);
  :func:`~deepinteract_tpu_torch.models.interaction.interaction_tensor`
  produces the same ``[feats1 | feats2]`` channel order, so the decoder's
  first conv needs **no input-channel permutation** either.
* The conformation ``ResBlock`` registers ONE norm object at ModuleList
  indices 1, 4 and 7 (``deepinteract_modules.py:468-479``); torch emits
  duplicate state-dict entries for every alias. Index 1 is read, and
  indices 4/7 must be byte-identical (they share storage in a real
  checkpoint).

Keys that carry no weights are dropped: ``num_batches_tracked``, the
regional attention's constant ``stretch_layer.weight``
(``deepinteract_modules.py:1138-1141``), and any torchmetrics buffers.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, List, Mapping, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Tensor transforms (torch layout -> flax layout)
# ---------------------------------------------------------------------------


def _t_linear(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.T)


def _t_conv(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _t_id(w: np.ndarray) -> np.ndarray:
    return np.asarray(w)


# Inverses, used to synthesize reference-layout state dicts in tests.
_INVERSE = {_t_linear: _t_linear, _t_conv: lambda w: np.transpose(w, (3, 2, 0, 1)),
            _t_id: _t_id}


@dataclasses.dataclass(frozen=True)
class _Rule:
    """One flax leaf's source: reference key, layout transform, and any
    duplicate reference keys that alias the same tensor (shared norms).

    ``stack > 0`` marks a scanned-decoder leaf (``scan_chunks``): ``ref_key``
    is then a template containing ``{i}`` and the flax leaf is the
    [stack, ...] stack of the ``stack`` per-chunk reference tensors."""

    ref_key: str
    transform: Callable[[np.ndarray], np.ndarray]
    aliases: Tuple[str, ...] = ()
    stack: int = 0


# ---------------------------------------------------------------------------
# Path mapping
# ---------------------------------------------------------------------------

_NORM_PARAM = {"scale": "weight", "bias": "bias"}
_NORM_STAT = {"mean": "running_mean", "var": "running_var"}

# MLP ModuleList: [Linear, act, dropout, Linear] (deepinteract_modules.py:
# 628-634) — trainables sit at indices 0 and 3.
_MLP_INDEX = {"GODense_0": 0, "GODense_1": 3}
# ResBlock ModuleList: [Lin, norm, act] x3 (:468-479) — Linears at 0/3/6,
# the shared norm object at 1 (aliased at 4 and 7).
_RESBLOCK_LINEAR = {"linear_0": 0, "linear_1": 3, "linear_2": 6}

IGNORED_REF_KEY_PATTERNS = (
    r"\.num_batches_tracked$",
    r"\.stretch_layer\.weight$",  # constant window-unfold weight (:1138-1141)
    r"^(train|val|test)_(acc|prec|recall|auroc|auprc|f1)\.",  # torchmetrics
    r"^loss_fn\.",
)


def _norm_leaf(ref_module: str, leaf: str, collection: str, aliases=()) -> _Rule:
    table = _NORM_PARAM if collection == "params" else _NORM_STAT
    return _Rule(f"{ref_module}.{table[leaf]}", _t_id,
                 tuple(f"{a}.{table[leaf]}" for a in aliases))


def _dense_leaf(ref_module: str, leaf: str) -> _Rule:
    if leaf == "kernel":
        return _Rule(f"{ref_module}.weight", _t_linear)
    return _Rule(f"{ref_module}.bias", _t_id)


def _conv_leaf(ref_module: str, leaf: str) -> _Rule:
    if leaf == "kernel":
        return _Rule(f"{ref_module}.weight", _t_conv)
    return _Rule(f"{ref_module}.bias", _t_id)


def _map_resblock(base: str, rest: Tuple[str, ...], collection: str) -> _Rule:
    """``{pre,post}_res_block_{j}`` -> ``{pre,post}_res_blocks.{j}.res_block.*``."""
    kind, j = rest[0].rsplit("_", 1)  # 'pre_res_block', '0'
    blocks = "pre_res_blocks" if kind.startswith("pre") else "post_res_blocks"
    child = rest[1]
    leaf = rest[-1]
    prefix = f"{base}.{blocks}.{j}.res_block"
    if child == "shared_norm":
        return _norm_leaf(f"{prefix}.1", leaf, collection,
                          aliases=(f"{prefix}.4", f"{prefix}.7"))
    return _dense_leaf(f"{prefix}.{_RESBLOCK_LINEAR[child]}", leaf)


def _map_gt_layer(idx: int, rest: Tuple[str, ...], collection: str,
                  norm_type: str) -> _Rule:
    base = f"gnn_module.0.gt_block.{idx}"
    sub = rest[0]
    leaf = rest[-1]
    norm_prefix = "layer_norm" if norm_type == "layer" else "batch_norm"
    if sub == "conformation_module":
        child = rest[1]
        if child.startswith(("pre_res_block_", "post_res_block_")):
            return _map_resblock(f"{base}.conformation_module", rest[1:], collection)
        if child == "linear":  # PlainEdgeModule (disable_geometric_mode)
            return _dense_leaf(f"{base}.conformation_module", leaf)
        return _dense_leaf(f"{base}.conformation_module.{child}", leaf)
    if sub.startswith(("norm1_", "norm2_")):
        which, what = sub.split("_")  # norm1, node|edge
        n = which[-1]
        return _norm_leaf(f"{base}.{norm_prefix}{n}_{what}_feats", leaf, collection)
    if sub == "mha":
        return _dense_leaf(f"{base}.mha_module.{rest[1]}", leaf)
    if sub == "O_node":
        return _dense_leaf(f"{base}.O_node_feats", leaf)
    if sub == "O_edge":
        return _dense_leaf(f"{base}.O_edge_feats", leaf)
    if sub in ("node_mlp", "edge_mlp"):
        mlp = "node_feats_MLP" if sub == "node_mlp" else "edge_feats_MLP"
        return _dense_leaf(f"{base}.{mlp}.{_MLP_INDEX[rest[1]]}", leaf)
    raise KeyError(f"unmapped GT-layer path: {sub}/{'/'.join(rest)}")


def _unit_rule(stem: str, unit: str, tail: Tuple[str, ...], leaf: str,
               stack: int = 0) -> _Rule:
    """Map one bottleneck-block sub-unit (conv/inorm/se) under ``stem``."""
    if unit.startswith("conv2d_"):
        rule = _conv_leaf(f"{stem}_{unit}", leaf)
    elif unit.startswith("inorm_"):
        rule = _norm_leaf(f"{stem}_{unit}", leaf, "params")
    elif unit == "se_block":
        lin = {"Dense_0": "linear1", "Dense_1": "linear2"}[tail[0]]
        rule = _dense_leaf(f"{stem}_se_block.{lin}", leaf)
    else:
        raise KeyError(f"unmapped block unit: {stem}/{unit}")
    return dataclasses.replace(rule, stack=stack) if stack else rule


def _map_decoder(rest: Tuple[str, ...], num_chunks: int = 14) -> _Rule:
    base = "interact_module"
    sub = rest[0]
    leaf = rest[-1]
    if sub in ("conv2d_1", "phase2_conv"):
        return _conv_leaf(f"{base}.{sub}", leaf)
    if sub == "inorm_1":
        return _norm_leaf(f"{base}.inorm_1", leaf, "params")
    if sub in ("mha2d_1", "mha2d_2"):
        n = sub[-1]
        return _conv_leaf(f"{base}.MHA2D_{n}.{rest[1]}", leaf)
    if sub in ("base_resnet", "phase2_resnet"):
        # ResNet submodules are name-mangled with the constructor's
        # module_name: 'base_resnet' / 'bin_resnet' (:1187-1201).
        mod = "base_resnet" if sub == "base_resnet" else "bin_resnet"
        child = rest[1]
        if child == "init_proj":
            prefix = f"{base}.{sub}.resnet_{mod}_init_proj"
            return _conv_leaf(prefix, leaf)
        if child == "chunks":
            # Scanned layout (DecoderConfig.scan_chunks): one flax leaf
            # stacks the num_chunks per-chunk reference tensors; '{i}' in
            # the template is the chunk index.
            d = rest[2].rsplit("d", 1)[1]  # block_d{d}
            stem = f"{base}.{sub}.resnet_{mod}_{{i}}_{d}"
            return _unit_rule(stem, rest[3], rest[4:], leaf, stack=num_chunks)
        if child.startswith("extra_block_"):
            i = child.rsplit("_", 1)[1]
            stem = f"{base}.{sub}.resnet_{mod}_extra{i}"
        else:  # block_{i}_{d}
            _, i, d = child.split("_")
            stem = f"{base}.{sub}.resnet_{mod}_{i}_{d}"
        return _unit_rule(stem, rest[2], rest[3:], leaf)
    raise KeyError(f"unmapped decoder path: {'/'.join(rest)}")


def map_flax_path(collection: str, path: Tuple[str, ...], num_layers: int,
                  norm_type: str = "batch", num_chunks: int = 14) -> _Rule:
    """Map one flax leaf path (without the collection prefix) to its
    reference state-dict source."""
    head = path[0]
    if head == "node_in_embedding":
        return _dense_leaf("node_in_embedding", path[-1])
    if head == "gnn":
        sub = path[1]
        if sub == "init_edge_module":
            base = "gnn_module.0.init_edge_module"
            if path[2] == "node_embedding":
                return _Rule(f"{base}.node_embedding.weight", _t_id)
            if path[2] == "linear":  # PlainEdgeModule in geometric-off mode
                return _dense_leaf(base, path[-1])
            return _dense_leaf(f"{base}.{path[2]}", path[-1])
        if sub.startswith("gcn_bias_"):
            i = sub.rsplit("_", 1)[1]
            return _Rule(f"gnn_module.{i}.bias", _t_id)
        if sub.startswith("gcn_"):
            # DGL GraphConv stores weight as [in, out] and right-multiplies
            # (dgl GraphConv matmul convention) — no transpose.
            i = sub.rsplit("_", 1)[1]
            return _Rule(f"gnn_module.{i}.weight", _t_id)
        if sub == "final_gt_layer":
            return _map_gt_layer(num_layers - 1, path[2:], collection, norm_type)
        if sub.startswith("gt_layer_"):
            idx = int(sub.rsplit("_", 1)[1])
            return _map_gt_layer(idx, path[2:], collection, norm_type)
    if head == "decoder":
        return _map_decoder(path[1:], num_chunks)
    raise KeyError(f"unmapped flax path: {collection}/{'/'.join(path)}")


# ---------------------------------------------------------------------------
# Tree walking
# ---------------------------------------------------------------------------


def _iter_leaf_paths(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _iter_leaf_paths(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _set_leaf(tree: Dict[str, Any], path: Tuple[str, ...], value) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def abstract_variables(model_cfg) -> Dict[str, Any]:
    """The variables tree of ``model_cfg``'s model, shapes only (tuples of
    ints at the leaves), from a port model built on the meta device: no
    memory, no init."""
    import torch

    from deepinteract_tpu_torch.models.model import DeepInteract
    from deepinteract_tpu_torch.weights import jax_variable_shapes

    with torch.device("meta"):
        model = DeepInteract(model_cfg)
    return jax_variable_shapes(model)


@dataclasses.dataclass
class ImportReport:
    consumed: List[str]
    ignored: List[str]
    unconsumed: List[str]

    def summary(self) -> str:
        return (f"imported {len(self.consumed)} tensors "
                f"({len(self.ignored)} ignored, {len(self.unconsumed)} unconsumed)")


def _clean_key(key: str) -> str:
    # Lightning sometimes nests the network under 'model.' — strip it.
    return key[len("model."):] if key.startswith("model.") else key


def convert_state_dict(
    ref_sd: Mapping[str, np.ndarray],
    model_cfg,
    strict: bool = True,
) -> Tuple[Dict[str, Any], ImportReport]:
    """Convert a reference-layout state dict into ``{"params": ...,
    "batch_stats": ...}`` matching the JAX package's tree for
    ``model_cfg`` (a port ``ModelConfig``), validating shapes and
    accounting for every reference key. Strict: a reference key the model
    needs that is absent, or one that maps nowhere, raises KeyError."""
    if model_cfg.interact_module_type != "dilated":
        raise ValueError("the reference checkpoint importer maps the dilated ResNet "
                         f"decoder only, not {model_cfg.interact_module_type!r}")
    sd = {_clean_key(k): np.asarray(v) for k, v in ref_sd.items()}
    abstract = abstract_variables(model_cfg)
    num_layers = model_cfg.gnn.num_layers
    norm_type = model_cfg.gnn.norm_type

    num_chunks = model_cfg.decoder.num_chunks

    out: Dict[str, Any] = {}
    consumed: Dict[str, str] = {}
    missing: List[str] = []
    for collection in ("params", "batch_stats"):
        for path, leaf in _iter_leaf_paths(abstract.get(collection, {})):
            rule = map_flax_path(collection, path, num_layers, norm_type,
                                 num_chunks)
            if rule.stack:
                # Scanned decoder leaf: stack the per-chunk reference tensors.
                keys = [rule.ref_key.format(i=i) for i in range(rule.stack)]
                absent = [k for k in keys if k not in sd]
                if absent:
                    missing.extend(absent)
                    continue
                value = np.stack([rule.transform(sd[k]) for k in keys])
                if tuple(value.shape) != tuple(leaf):
                    raise ValueError(
                        f"shape mismatch for stacked {rule.ref_key} -> "
                        f"{collection}/{'/'.join(path)}: got {value.shape}, "
                        f"expected {tuple(leaf)}"
                    )
                _set_leaf(out, (collection,) + path, value.astype(np.float32))
                for k in keys:
                    consumed[k] = "/".join(path)
                continue
            if rule.ref_key not in sd:
                missing.append(rule.ref_key)
                continue
            value = rule.transform(sd[rule.ref_key])
            if tuple(value.shape) != tuple(leaf):
                raise ValueError(
                    f"shape mismatch for {rule.ref_key} -> "
                    f"{collection}/{'/'.join(path)}: got {value.shape}, "
                    f"expected {tuple(leaf)}"
                )
            _set_leaf(out, (collection,) + path, value.astype(np.float32))
            consumed[rule.ref_key] = "/".join(path)
            for alias in rule.aliases:
                if alias in sd:
                    if not np.array_equal(sd[alias], sd[rule.ref_key]):
                        raise ValueError(
                            f"shared-norm alias {alias} differs from "
                            f"{rule.ref_key}; checkpoint is not reference-shaped"
                        )
                    consumed[alias] = consumed[rule.ref_key]
    if missing and strict:
        raise KeyError(
            f"{len(missing)} expected reference keys absent, e.g. {missing[:5]}"
        )

    ignored, unconsumed = [], []
    for key in sd:
        if key in consumed:
            continue
        if any(re.search(p, key) for p in IGNORED_REF_KEY_PATTERNS):
            ignored.append(key)
        else:
            unconsumed.append(key)
    if unconsumed and strict:
        raise KeyError(
            f"{len(unconsumed)} reference keys not mapped, e.g. {sorted(unconsumed)[:5]}"
        )
    out.setdefault("params", {})
    out.setdefault("batch_stats", {})
    return out, ImportReport(sorted(consumed), sorted(ignored), sorted(unconsumed))


def synthesize_reference_state_dict(model_cfg, seed: int = 0) -> Dict[str, np.ndarray]:
    """Build a random state dict in the exact reference layout (names,
    torch-convention shapes, shared-norm duplicate entries, decoy buffers)
    for ``model_cfg`` (a port ``ModelConfig``): a stand-in for the
    published checkpoint where that is not at hand."""
    rng = np.random.default_rng(seed)
    abstract = abstract_variables(model_cfg)
    sd: Dict[str, np.ndarray] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _iter_leaf_paths(abstract.get(collection, {})):
            rule = map_flax_path(collection, path, model_cfg.gnn.num_layers,
                                 model_cfg.gnn.norm_type,
                                 model_cfg.decoder.num_chunks)
            if rule.ref_key in sd:
                continue  # shared (aliased) tensors emitted once below
            flax_value = rng.standard_normal(leaf).astype(np.float32)
            if len(leaf) >= 2:
                # realistic magnitude (fan-in scaled) so a forward pass with
                # these synthetic weights stays finite through 60+ layers.
                # The stacked chunk axis is not part of the fan-in.
                fan_shape = leaf[1:-1] if rule.stack else leaf[:-1]
                fan_in = int(np.prod(fan_shape))
                flax_value *= 1.0 / np.sqrt(max(fan_in, 1))
            if path[-1] == "var":  # running variances must be positive
                flax_value = np.abs(flax_value) + 0.5
            if rule.stack:
                # One reference tensor per chunk (the flax leaf's leading
                # axis).
                for i in range(rule.stack):
                    sd[rule.ref_key.format(i=i)] = np.ascontiguousarray(
                        _INVERSE[rule.transform](flax_value[i])
                    )
                continue
            ref_value = _INVERSE[rule.transform](flax_value)
            sd[rule.ref_key] = np.ascontiguousarray(ref_value)
            for alias in rule.aliases:
                sd[alias] = sd[rule.ref_key]
            if rule.ref_key.endswith("running_var"):
                # BatchNorm ships a counter buffer alongside its stats.
                sd[rule.ref_key.replace("running_var", "num_batches_tracked")] = (
                    np.asarray(7, dtype=np.int64)
                )
    return sd
