"""On-disk complex format: one compressed ``.npz`` per complex.

Port of ``deepinteract_tpu/data/io.py``; the format is the interchange
with the JAX package, so the schema is identical (unpadded):
  g{1,2}_node_feats [N,113], g{1,2}_coords [N,3], g{1,2}_edge_feats [N,K,28],
  g{1,2}_nbr_idx [N,K], g{1,2}_src_nbr_eids / _dst_nbr_eids [N,K,G],
  examples [M,3] (i, j, label over all chain1 x chain2 pairs),
  complex_name (str).
"""

from __future__ import annotations

import zipfile
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from deepinteract_tpu_torch.data.graph import PairedComplex, pad_graph, pick_bucket

GRAPH_KEYS = ("node_feats", "coords", "edge_feats", "nbr_idx", "src_nbr_eids", "dst_nbr_eids")


def save_complex_npz(
    path: str,
    raw1: Dict[str, np.ndarray],
    raw2: Dict[str, np.ndarray],
    examples: np.ndarray,
    complex_name: str = "",
) -> None:
    payload = {}
    for prefix, raw in (("g1", raw1), ("g2", raw2)):
        for key in GRAPH_KEYS:
            payload[f"{prefix}_{key}"] = np.asarray(raw[key])
    payload["examples"] = np.asarray(examples, dtype=np.int32)
    payload["complex_name"] = np.asarray(complex_name)
    np.savez_compressed(path, **payload)


def load_complex_npz(path_or_file) -> Dict:
    """Load a complex from a path or a binary file-like object.
    ``complex_name`` is optional on read."""
    with np.load(path_or_file, allow_pickle=False) as z:
        return {
            "graph1": {key: z[f"g1_{key}"] for key in GRAPH_KEYS},
            "graph2": {key: z[f"g2_{key}"] for key in GRAPH_KEYS},
            "examples": z["examples"],
            "complex_name": (str(z["complex_name"])
                             if "complex_name" in z else ""),
        }


def complex_lengths_from_file(path: str) -> Tuple[int, int]:
    """(n1, n2) from the npy headers of a complex ``.npz`` alone, without
    decompressing any array (bucket planning reads every file of a
    dataset)."""
    readers = {(1, 0): np.lib.format.read_array_header_1_0,
               (2, 0): np.lib.format.read_array_header_2_0}
    out = []
    with zipfile.ZipFile(path) as z:
        for member in ("g1_node_feats.npy", "g2_node_feats.npy"):
            with z.open(member) as f:
                reader = readers.get(tuple(np.lib.format.read_magic(f)))
                if reader is None:  # an npy version without a header reader
                    with z.open(member) as whole:
                        out.append(int(np.lib.format.read_array(whole).shape[0]))
                    continue
                out.append(int(reader(f)[0][0]))
    return out[0], out[1]


def examples_to_contact_map(examples: np.ndarray, n1: int, n2: int) -> np.ndarray:
    """Dense 0/1 [n1, n2] map from the flattened (i, j, label) example list."""
    m = np.zeros((n1, n2), dtype=np.int64)
    m[examples[:, 0], examples[:, 1]] = examples[:, 2]
    return m


def to_paired_complex(
    raw: Dict,
    n_pad1: Optional[int] = None,
    n_pad2: Optional[int] = None,
    input_indep: bool = False,
) -> PairedComplex:
    """Pad a loaded complex into model-ready CPU tensors.

    ``input_indep`` zeroes all node/edge input features (the reference's
    input-independence control)."""
    raw1, raw2 = raw["graph1"], raw["graph2"]
    if input_indep:
        raw1 = dict(raw1, node_feats=np.zeros_like(raw1["node_feats"]),
                    edge_feats=np.zeros_like(raw1["edge_feats"]))
        raw2 = dict(raw2, node_feats=np.zeros_like(raw2["node_feats"]),
                    edge_feats=np.zeros_like(raw2["edge_feats"]))
    n1 = raw1["node_feats"].shape[0]
    n2 = raw2["node_feats"].shape[0]
    p1 = n_pad1 or pick_bucket(n1)
    p2 = n_pad2 or pick_bucket(n2)

    examples = np.asarray(raw["examples"], dtype=np.int64)
    contact_map = np.zeros((p1, p2), dtype=np.int64)
    contact_map[:n1, :n2] = examples_to_contact_map(examples, n1, n2)

    m_pad = p1 * p2
    examples_padded = np.zeros((m_pad, 3), dtype=np.int64)
    example_mask = np.zeros(m_pad, dtype=bool)
    examples_padded[: examples.shape[0]] = examples
    example_mask[: examples.shape[0]] = True

    return PairedComplex(
        graph1=pad_graph(raw1, p1),
        graph2=pad_graph(raw2, p2),
        examples=torch.from_numpy(examples_padded),
        example_mask=torch.from_numpy(example_mask),
        contact_map=torch.from_numpy(contact_map),
    )
