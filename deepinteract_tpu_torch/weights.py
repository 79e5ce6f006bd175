"""Weights for the port: JAX parameter trees carried across, the flat-path
``.npz`` that ``--weights`` takes, and a seeded init.

The JAX package's variables are ``{"params": ..., "batch_stats": ...}``
trees of arrays. The port's modules carry the flax module names, so a flax
path maps onto a torch module path; flax's automatic wrapper names
(``Dense_0`` inside a ``GODense``, ``MaskedBatchNorm_0`` inside a
``FeatureNorm``) are skipped, and modules with renamed children declare
``flax_names``. Leaves convert as:
  * Dense ``kernel [in, out]`` -> Linear ``weight [out, in]``;
  * Conv ``kernel`` HWIO -> OIHW;
  * Embed ``embedding`` -> ``weight``; norm ``scale`` -> ``weight``;
  * BatchNorm ``mean`` / ``var`` -> ``running_mean`` / ``running_var``;
  * the decoder's entry conv ``kernel [1, 1, 2C, F]`` -> the factorized
    stem's two per-chain halves;
  * a parameter declared directly on a module (the GCN's ``gcn_bias_{i}``)
    -> the port module's parameter of that name.
The scanned decoder layout (``base_resnet/chunks/block_d{d}/...`` with a
leading ``[num_chunks]`` axis) is unstacked to ``block_{i}_{d}``; the
unrolled layout is taken as it is. A key that maps nowhere, or a port
tensor that no key fills, raises.

:func:`jax_variable_shapes` runs the other way: the flax paths and shapes
of the JAX package's variables for a port model, which the reference
checkpoint importer (``training/import_torch.py``) fills.
"""

from __future__ import annotations

import hashlib
import math
import re
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from deepinteract_tpu_torch.models.decoder import (POSITIVE_CLASS_BIAS, InstanceNorm,
                                                   InteractionDecoder)
from deepinteract_tpu_torch.models.layers import GODense, LayerNorm, MaskedBatchNorm
from deepinteract_tpu_torch.models.stem import PairStem1x1
from deepinteract_tpu_torch.models.vision import DeepLabDecoder

_NORMS = (MaskedBatchNorm, LayerNorm, InstanceNorm)
_LEAVES = (nn.Linear, nn.Conv2d, nn.Embedding, PairStem1x1) + _NORMS
_FLAX_AUTONAME = re.compile(r"^[A-Za-z]+_\d+$")
_NORM_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
                "var": "running_var"}


def _iter_leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _iter_leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _set_leaf(tree: Dict, path: Tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def unstack_chunks(tree: Mapping) -> Dict:
    """Scanned decoder layout -> unrolled: every ``chunks/block_d{d}/...``
    subtree with a leading [num_chunks] axis becomes ``block_{i}_{d}/...``
    beside it (the inverse of the JAX package's ``stack_chunk_params``)."""
    out = {}
    for key, value in tree.items():
        if not isinstance(value, Mapping):
            out[key] = value
        elif key == "chunks":
            for block, sub in value.items():
                d = block[len("block_d"):]
                for path, leaf in _iter_leaves(sub):
                    for i in range(leaf.shape[0]):
                        _set_leaf(out, (f"block_{i}_{d}",) + path, leaf[i])
        else:
            out[key] = unstack_chunks(value)
    return out


def _own_param(mod: nn.Module, leaf: str) -> bool:
    """A flax leaf declared on a module itself (``self.param`` beside its
    submodules), which the port holds as a parameter of the same name."""
    return not isinstance(mod, _LEAVES) and leaf in mod._parameters


def _resolve(model: nn.Module, path: Tuple[str, ...]) -> Tuple[nn.Module, str]:
    """Walk a flax leaf's path down the port's modules -> (the module that
    holds the leaf, its dotted state-dict prefix)."""
    mod, names = model, []
    for seg in path[:-1]:
        child_name = getattr(mod, "flax_names", {}).get(seg, seg)
        child = mod._modules.get(child_name)
        if child is not None:
            mod = child
            names.append(child_name)
        elif not (isinstance(mod, _LEAVES) and _FLAX_AUTONAME.match(seg)):
            raise KeyError(f"flax path {'/'.join(path)} has no counterpart in "
                           f"the port (no submodule {seg!r} under "
                           f"{'.'.join(names) or 'the model'})")
    if not (isinstance(mod, _LEAVES) or _own_param(mod, path[-1])):
        raise KeyError(f"flax path {'/'.join(path)} does not end at a layer")
    return mod, ".".join(names)


def _convert_leaf(mod: nn.Module, leaf: str, value: np.ndarray) -> Dict[str, np.ndarray]:
    """One flax leaf -> {torch state-dict name (relative to mod): array}."""
    if _own_param(mod, leaf):
        return {leaf: value}
    if isinstance(mod, PairStem1x1):
        if leaf == "bias":
            return {"chain2.bias": value}
        if leaf == "kernel":
            half = value.shape[2] // 2
            return {"chain1.weight": value[0, 0, :half].T, "chain2.weight": value[0, 0, half:].T}
    elif isinstance(mod, _NORMS) and leaf in _NORM_LEAVES:
        return {_NORM_LEAVES[leaf]: value}
    elif isinstance(mod, nn.Embedding) and leaf == "embedding":
        return {"weight": value}
    elif isinstance(mod, nn.Linear) and leaf in ("kernel", "bias"):
        return {"weight": value.T} if leaf == "kernel" else {"bias": value}
    elif isinstance(mod, nn.Conv2d) and leaf in ("kernel", "bias"):
        return {"weight": value.transpose(3, 2, 0, 1)} if leaf == "kernel" else {"bias": value}
    raise KeyError(f"unknown leaf {leaf!r} for {type(mod).__name__}")


# flax wraps these port layers in one more auto-named module.
_FLAX_WRAPPER = ((GODense, "Dense_0"), (MaskedBatchNorm, "MaskedBatchNorm_0"),
                 (LayerNorm, "LayerNorm_0"))


def _flax_leaves(mod: nn.Module) -> Dict[str, Tuple[str, Tuple[int, ...]]]:
    """The inverse of :func:`_convert_leaf` for a layer: {flax leaf name:
    (collection, flax shape)}."""
    if isinstance(mod, PairStem1x1):
        f = mod.chain2.out_features
        return {"kernel": ("params", (1, 1, mod.chain1.in_features + mod.chain2.in_features, f)),
                "bias": ("params", (f,))}
    out = {}
    if isinstance(mod, _NORMS):
        for leaf, name in _NORM_LEAVES.items():
            t = getattr(mod, name, None)
            if isinstance(t, torch.Tensor):
                out[leaf] = ("batch_stats" if leaf in ("mean", "var") else "params",
                             tuple(t.shape))
    elif isinstance(mod, nn.Embedding):
        out["embedding"] = ("params", tuple(mod.weight.shape))
    elif isinstance(mod, nn.Linear):
        out["kernel"] = ("params", tuple(mod.weight.shape[::-1]))
    elif isinstance(mod, nn.Conv2d):
        o, i, kh, kw = mod.weight.shape
        out["kernel"] = ("params", (kh, kw, i, o))
    if isinstance(mod, (nn.Linear, nn.Conv2d)) and mod.bias is not None:
        out["bias"] = ("params", tuple(mod.bias.shape))
    return out


def jax_variable_shapes(model: nn.Module, scan_chunks: bool = True) -> Dict:
    """The JAX package's variables tree for the same model, shapes only:
    ``{"params": {...}, "batch_stats": {...}}`` with a tuple of ints at
    each flax leaf path, as ``jax.eval_shape`` of its init gives it. The
    inverse of :func:`_resolve` and :func:`_convert_leaf`: child names
    map back through ``flax_names``, and the layers flax wraps once more
    get their auto-name (``Dense_0`` in a ``GODense``, ``MaskedBatchNorm_0``
    / ``LayerNorm_0`` in a feature norm). With ``scan_chunks`` (the JAX
    ``DecoderConfig`` default) the base ResNet's ``block_{i}_{d}`` stack
    into ``chunks/block_d{d}`` leaves with a leading [num_chunks] axis.
    Works on a model built on the meta device."""
    tree: Dict = {"params": {}, "batch_stats": {}}

    def walk(mod: nn.Module, path: Tuple[str, ...]) -> None:
        if isinstance(mod, _LEAVES):
            wrap = tuple(name for cls, name in _FLAX_WRAPPER if isinstance(mod, cls))
            for leaf, (collection, shape) in _flax_leaves(mod).items():
                _set_leaf(tree[collection], path + wrap + (leaf,), shape)
            return
        for name, param in mod._parameters.items():
            if param is not None:
                _set_leaf(tree["params"], path + (name,), tuple(param.shape))
        flax_of = {child: flax for flax, child in getattr(mod, "flax_names", {}).items()}
        for name, child in mod._modules.items():
            if child is not None:
                walk(child, path + (flax_of.get(name, name),))

    walk(model, ())
    if scan_chunks:
        for collection in tree.values():
            resnet = collection.get("decoder", {}).get("base_resnet")
            if resnet is not None:
                _stack_chunks(resnet)
    return tree


def _stack_chunks(resnet: Dict) -> None:
    """``block_{i}_{d}`` subtrees -> ``chunks/block_d{d}`` with a leading
    [num_chunks] axis on every leaf shape (the JAX ``stack_chunk_params``)."""
    blocks = [k for k in resnet if re.fullmatch(r"block_\d+_\d+", k)]
    num_chunks = len({k.split("_")[1] for k in blocks})

    def stacked(tree):
        return {k: stacked(v) if isinstance(v, dict) else (num_chunks,) + v
                for k, v in tree.items()}

    chunks = {}
    for key in blocks:
        sub = resnet.pop(key)
        chunks[f"block_d{key.split('_')[2]}"] = stacked(sub)
    if chunks:
        resnet["chunks"] = chunks


def load_jax_variables(model: nn.Module, variables: Mapping) -> None:
    """Fill ``model`` from a JAX ``{"params": ..., "batch_stats": ...}``
    tree of arrays (nested dicts; numpy, or anything ``np.asarray`` takes)
    for the same module. Raises on a key that maps nowhere, on a port
    tensor left unfilled, and on a shape mismatch."""
    state = model.state_dict()
    new_state: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        tree = unstack_chunks(variables.get(collection, {}))
        for path, value in _iter_leaves(tree):
            mod, prefix = _resolve(model, path)
            for name, array in _convert_leaf(mod, path[-1], np.asarray(value)).items():
                key = f"{prefix}.{name}" if prefix else name
                if key not in state:
                    raise KeyError(f"{collection}/{'/'.join(path)} -> {key}: no such tensor")
                if tuple(array.shape) != tuple(state[key].shape):
                    raise ValueError(f"{collection}/{'/'.join(path)} -> {key}: shape "
                                     f"{tuple(array.shape)}, expected {tuple(state[key].shape)}")
                new_state[key] = torch.from_numpy(np.ascontiguousarray(array, dtype=np.float32))
    missing = sorted(set(state) - set(new_state))
    if missing:
        raise KeyError(f"{len(missing)} port tensors not filled by the JAX "
                       f"variables, e.g. {missing[:5]}")
    model.load_state_dict(new_state, strict=True)


def save_npz(path: str, variables: Mapping) -> None:
    """Write a variables tree as a flat-path ``.npz``
    (``params/gnn/.../kernel`` -> array)."""
    flat = {"/".join(p): np.asarray(v) for p, v in _iter_leaves(variables)}
    np.savez(path, **flat)


def load_npz(path: str) -> Dict:
    """Read a flat-path ``.npz`` back into a nested variables tree."""
    tree: Dict = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            _set_leaf(tree, tuple(key.split("/")), z[key])
    return tree


# ---------------------------------------------------------------------------
# Seeded init (for runs without --weights)
# ---------------------------------------------------------------------------


def _glorot_orthogonal_(weight: torch.Tensor, gen: torch.Generator, scale: float = 2.0):
    """Orthogonal matrix rescaled to Glorot variance (the reference's
    ``glorot_orthogonal``): W <- W * sqrt(scale / ((fan_in + fan_out) *
    var(W))). ``weight`` is torch-layout [out, in]."""
    fan_out, fan_in = weight.shape
    a = torch.randn(max(fan_in, fan_out), min(fan_in, fan_out), generator=gen)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    w = q if fan_out >= fan_in else q.T  # [out, in]
    w = w * torch.sqrt(scale / ((fan_in + fan_out) * torch.clamp(w.var(), min=1e-12)))
    weight.copy_(w)


def _lecun_normal_(weight: torch.Tensor, gen: torch.Generator, fan_in: int):
    """flax's ``lecun_normal``: truncated normal (+-2 sigma) with variance
    1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=gen)


def carried_signature(model: nn.Module) -> str:
    """The ``weights_signature`` of carried JAX variables (a tree or a
    ``.npz``): a digest of the loaded state, so two workers that load the
    same weights from different paths agree, and a rollover's target
    signature proves the content that landed, not a file name."""
    h = hashlib.sha256()
    for name, t in model.state_dict().items():
        h.update(name.encode() + t.detach().cpu().numpy().tobytes())
    return f"jax-variables:{h.hexdigest()[:16]}"


def seeded_signature(seed: int) -> str:
    """The ``weights_signature`` of the port's seeded init. It names the
    package: the JAX engine calls its own (different) seeded weights
    ``init-seed{n}``, so an index, calibration or embedding spill made by
    one package for seeded weights is refused by the other as stale."""
    return f"torch-init-seed{int(seed)}"


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> None:
    """Deterministic init from ``seed`` through an explicit CPU
    ``torch.Generator``: glorot orthogonal for ``GODense``, lecun normal
    for other dense and conv layers, U(+-sqrt 3) node embeddings, unit
    norms, zero biases, and -7 on the decoder's positive-class logit bias
    (the DeepLab head's with two classes).
    It follows the reference's init scheme, not its random numbers."""
    gen = torch.Generator().manual_seed(seed)
    halves = set()
    for mod in model.modules():
        if isinstance(mod, PairStem1x1):
            # One conv over 2C input channels, held as two halves.
            fan_in = mod.chain1.in_features + mod.chain2.in_features
            for half in (mod.chain1, mod.chain2):
                _lecun_normal_(half.weight, gen, fan_in)
                halves.add(half)
            mod.chain2.bias.zero_()
        elif isinstance(mod, nn.Linear) and mod not in halves:
            if isinstance(mod, GODense):
                _glorot_orthogonal_(mod.weight, gen)
            else:
                _lecun_normal_(mod.weight, gen, mod.in_features)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Conv2d):
            _lecun_normal_(mod.weight, gen, mod.weight[0].numel())
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            nn.init.uniform_(mod.weight, -math.sqrt(3.0), math.sqrt(3.0), generator=gen)
        elif isinstance(mod, _NORMS):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    decoder = getattr(model, "decoder", None)
    if isinstance(decoder, InteractionDecoder):
        decoder.phase2_conv.bias[1] = POSITIVE_CLASS_BIAS
    elif isinstance(decoder, DeepLabDecoder) and decoder.cfg.num_classes == 2:
        decoder.head.bias[-1] = POSITIVE_CLASS_BIAS
