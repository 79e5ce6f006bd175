"""Converter: reference processed complexes -> our ``.npz`` format.

The reference stores each complex as a pickled dict
``{'graph1': dgl.DGLGraph, 'graph2': dgl.DGLGraph, 'examples': torch.Tensor,
'complex': str}`` (``process_complex_into_dict``,
deepinteract_utils.py:924-965). Its DGL kNN graphs have fixed out-degree K
with edges grouped by source node in row-major order, so the COO edge list
maps losslessly onto our dense ``[N, K]`` layout (flat edge id i*K + k —
see ``data.graph.ProteinGraph``).

Inputs accepted per graph:
  * a real ``dgl.DGLGraph`` (if dgl is importable in the converting env), or
  * a plain schema-identical dict:
      {'num_nodes': int, 'edges': (src [E], dst [E]),
       'ndata': {'f': [N, 113], 'x': [N, 3]},
       'edata': {'f': [E, 28] (or [E, 27, 1] as the reference stores it),
                 'src_nbr_e_ids': [E, G], 'dst_nbr_e_ids': [E, G]}}
    — the form produced by dumping a DGL graph's fields to numpy anywhere
    dgl exists, so conversion itself needs no dgl.

Port of ``deepinteract_tpu/data/convert.py`` (the port imports nothing of the
JAX package); it writes and prints what the JAX one does.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Tuple

import numpy as np

from deepinteract_tpu_torch import constants
from deepinteract_tpu_torch.data.io import save_complex_npz


def _as_numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):  # torch.Tensor without importing torch
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _graph_fields(graph) -> Tuple[int, np.ndarray, np.ndarray, Dict, Dict]:
    """Extract (num_nodes, src, dst, ndata, edata) from either input form."""
    if isinstance(graph, dict):
        src, dst = graph["edges"]
        return (
            int(graph["num_nodes"]),
            _as_numpy(src),
            _as_numpy(dst),
            {k: _as_numpy(v) for k, v in graph["ndata"].items()},
            {k: _as_numpy(v) for k, v in graph["edata"].items()},
        )
    # Duck-typed dgl.DGLGraph.
    src, dst = graph.edges()
    return (
        int(graph.num_nodes()),
        _as_numpy(src),
        _as_numpy(dst),
        {k: _as_numpy(v) for k, v in graph.ndata.items()},
        {k: _as_numpy(v) for k, v in graph.edata.items()},
    )


def reference_graph_to_raw(graph) -> Dict[str, np.ndarray]:
    """One reference graph -> our unpadded raw dict (``io.GRAPH_KEYS``)."""
    n, src, dst, ndata, edata = _graph_fields(graph)
    e = src.shape[0]
    if n == 0 or e % n != 0:
        raise ValueError(f"edge count {e} is not a multiple of node count {n}")
    k = e // n

    # DGL knn_graph convention: edges grouped by source, K per node,
    # row-major flat ids (verified against deepinteract_utils.py:476).
    expected_src = np.repeat(np.arange(n, dtype=src.dtype), k)
    if not np.array_equal(src, expected_src):
        # Re-sort into row-major source-grouped order (stable keeps each
        # source's neighbor order).
        order = np.argsort(src, kind="stable")
        src, dst = src[order], dst[order]
        if not np.array_equal(src, expected_src):
            raise ValueError("graph is not a fixed out-degree kNN graph")
        edata = {key: v[order] for key, v in edata.items()}
        # Flat edge ids in neighbor-id arrays refer to the ORIGINAL edge
        # ordering; remap them.
        inv = np.empty(e, dtype=np.int64)
        inv[order] = np.arange(e)
        for key in ("src_nbr_e_ids", "dst_nbr_e_ids"):
            if key in edata:
                edata[key] = inv[edata[key].astype(np.int64)]

    edge_feats = edata["f"]
    if edge_feats.ndim == 3:  # reference stores [E, C, 1]
        edge_feats = edge_feats.squeeze(-1)
    if edge_feats.shape[-1] == constants.NUM_EDGE_FEATS - 1:
        # A 27-column variant (without the amide angle): zero-pad to 28.
        edge_feats = np.concatenate(
            [edge_feats, np.zeros((e, 1), edge_feats.dtype)], axis=-1
        )
    if edge_feats.shape[-1] != constants.NUM_EDGE_FEATS:
        raise ValueError(f"unexpected edge feature width {edge_feats.shape[-1]}")

    node_feats = ndata["f"]
    if node_feats.shape[-1] != constants.NUM_NODE_FEATS:
        raise ValueError(f"unexpected node feature width {node_feats.shape[-1]}")

    g = edata["src_nbr_e_ids"].shape[-1]
    return {
        "node_feats": node_feats.astype(np.float32),
        "coords": ndata["x"].astype(np.float32),
        "edge_feats": edge_feats.astype(np.float32).reshape(n, k, constants.NUM_EDGE_FEATS),
        "nbr_idx": dst.astype(np.int32).reshape(n, k),
        "src_nbr_eids": edata["src_nbr_e_ids"].astype(np.int32).reshape(n, k, g),
        "dst_nbr_eids": edata["dst_nbr_e_ids"].astype(np.int32).reshape(n, k, g),
    }


def reference_dict_to_npz(processed: Dict, npz_path: str) -> None:
    """Convert one loaded reference processed-complex dict and write npz."""
    raw1 = reference_graph_to_raw(processed["graph1"])
    raw2 = reference_graph_to_raw(processed["graph2"])
    examples = _as_numpy(processed["examples"]).astype(np.int32)
    save_complex_npz(npz_path, raw1, raw2, examples,
                     complex_name=str(processed.get("complex", "")))


def convert_file(dill_path: str, npz_path: str) -> None:
    """Convert one reference ``.dill`` file. Unpickling real files requires
    the ``dgl``/``torch`` of the producing environment; plain-dict pickles
    (see module docstring) load anywhere."""
    with open(dill_path, "rb") as f:
        try:
            processed = pickle.load(f)
        except ModuleNotFoundError as e:
            raise ModuleNotFoundError(
                f"{dill_path} pickles {e.name} objects; either convert in an "
                "environment with the reference's dependencies, or dump the "
                "graphs to the plain-dict form documented in "
                "deepinteract_tpu_torch.data.convert"
            ) from e
    reference_dict_to_npz(processed, npz_path)


def convert_tree(src_root: str, dst_root: str, suffix: str = ".dill") -> int:
    """Convert every ``*.dill`` under ``src_root`` into a mirrored ``.npz``
    tree under ``dst_root``. Returns the number converted."""
    count = 0
    for dirpath, _, files in os.walk(src_root):
        for fname in files:
            if not fname.endswith(suffix):
                continue
            rel = os.path.relpath(os.path.join(dirpath, fname), src_root)
            dst = os.path.join(dst_root, os.path.splitext(rel)[0] + ".npz")
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            convert_file(os.path.join(dirpath, fname), dst)
            count += 1
    return count
