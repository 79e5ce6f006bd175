"""Statically-shaped residue-graph containers as dataclasses of tensors.

Port of ``deepinteract_tpu/data/graph.py``. A kNN residue graph has fixed
out-degree K, so edges are stored densely as ``[N, K]`` neighbour slots:

* edge ``(i, k)`` points from source node i to its k-th nearest neighbour
  ``dst = nbr_idx[i, k]``; its flat edge id is ``i * K + k``;
* the edge softmax normalizes over a node's *incoming* edges (the
  reverse-kNN neighbourhood, variable degree).

All tensors are padded to a fixed ``N`` per shape bucket; ``node_mask``
marks real nodes, and padded nodes point at themselves. Batches stack
along a leading axis.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from deepinteract_tpu_torch import constants


@dataclasses.dataclass(frozen=True)
class ProteinGraph:
    """One protein chain (or a batch of them, with a leading axis).

    Shapes (unbatched):
      node_feats:    [N, 113] float32
      coords:        [N, 3]   float32 — CA coordinates
      edge_feats:    [N, K, 28] float32
      nbr_idx:       [N, K]  int64   — destination of edge (i, k)
      src_nbr_eids:  [N, K, G] int64 — flat ids of edges incident to the
                                       edge's source node
      dst_nbr_eids:  [N, K, G] int64 — same for the destination node
      node_mask:     [N]     bool    — True for real residues
      num_nodes:     []      int64   — number of real residues
    """

    node_feats: Any
    coords: Any
    edge_feats: Any
    nbr_idx: Any
    src_nbr_eids: Any
    dst_nbr_eids: Any
    node_mask: Any
    num_nodes: Any

    def edge_mask(self) -> torch.Tensor:
        """[..., N, K] mask of real edges: an edge is real iff its source
        node is real (padded nodes self-point)."""
        return self.node_mask[..., :, None].expand(self.nbr_idx.shape)

    def to(self, device) -> "ProteinGraph":
        return ProteinGraph(**{f.name: getattr(self, f.name).to(device)
                               for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class PairedComplex:
    """A two-chain complex plus its supervision targets.

      examples:     [M, 3] int64 — (row in chain1, col in chain2, label)
      example_mask: [M]    bool
      contact_map:  [N1, N2] int64 — dense 0/1 target (padded)
    """

    graph1: ProteinGraph
    graph2: ProteinGraph
    examples: Any
    example_mask: Any
    contact_map: Any

    @property
    def pair_mask(self) -> torch.Tensor:
        """[..., N1, N2] validity mask of the interaction map."""
        return self.graph1.node_mask[..., :, None] & self.graph2.node_mask[..., None, :]

    def to(self, device) -> "PairedComplex":
        return PairedComplex(
            graph1=self.graph1.to(device), graph2=self.graph2.to(device),
            examples=self.examples.to(device),
            example_mask=self.example_mask.to(device),
            contact_map=self.contact_map.to(device))


def _pad_axis0(arr: np.ndarray, target: int, fill=0) -> np.ndarray:
    pad = target - arr.shape[0]
    if pad < 0:
        raise ValueError(f"cannot pad array of length {arr.shape[0]} down to {target}")
    if pad == 0:
        return arr
    widths = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, widths, constant_values=fill)


def pad_graph(raw: Dict[str, np.ndarray], n_pad: int) -> ProteinGraph:
    """Pad a featurizer output dict (see ``features.featurize_chain``) to a
    static node count ``n_pad``. Padded nodes point at themselves with
    zeroed features, so gathers stay in bounds and contribute nothing under
    masking."""
    n = int(raw["node_feats"].shape[0])
    if n_pad < n:
        raise ValueError(f"chain of length {n} does not fit bucket {n_pad}")
    k = raw["nbr_idx"].shape[1]
    g = raw["src_nbr_eids"].shape[2]

    nbr_idx = _pad_axis0(raw["nbr_idx"].astype(np.int64), n_pad)
    src_eids = _pad_axis0(raw["src_nbr_eids"].astype(np.int64), n_pad)
    dst_eids = _pad_axis0(raw["dst_nbr_eids"].astype(np.int64), n_pad)
    if n_pad > n:
        nbr_idx[n:] = np.arange(n, n_pad)[:, None]  # self-pointing
        eid_fill = np.arange(n, n_pad)[:, None, None] * k  # in-bounds ids
        src_eids[n:] = np.broadcast_to(eid_fill, (n_pad - n, k, g))
        dst_eids[n:] = np.broadcast_to(eid_fill, (n_pad - n, k, g))

    as_t = torch.from_numpy
    return ProteinGraph(
        node_feats=as_t(_pad_axis0(raw["node_feats"].astype(np.float32), n_pad)),
        coords=as_t(_pad_axis0(raw["coords"].astype(np.float32), n_pad)),
        edge_feats=as_t(_pad_axis0(raw["edge_feats"].astype(np.float32), n_pad)),
        nbr_idx=as_t(nbr_idx),
        src_nbr_eids=as_t(src_eids),
        dst_nbr_eids=as_t(dst_eids),
        node_mask=as_t(_pad_axis0(np.ones(n, dtype=bool), n_pad)),
        num_nodes=torch.tensor(n, dtype=torch.int64),
    )


def pick_bucket(n: int, buckets=constants.CHAIN_LENGTH_BUCKETS) -> int:
    """Smallest bucket that fits a chain of length ``n`` (a multiple of the
    last bucket if the chain exceeds every bucket)."""
    for b in buckets:
        if n <= b:
            return b
    top = buckets[-1]
    return ((n + top - 1) // top) * top


def stack_graphs(graphs) -> ProteinGraph:
    """Batch graphs of identical padded shape along a new leading axis."""
    return ProteinGraph(**{
        f.name: torch.stack([getattr(g, f.name) for g in graphs])
        for f in dataclasses.fields(ProteinGraph)})


def stack_complexes(complexes) -> PairedComplex:
    return PairedComplex(
        graph1=stack_graphs([c.graph1 for c in complexes]),
        graph2=stack_graphs([c.graph2 for c in complexes]),
        examples=torch.stack([c.examples for c in complexes]),
        example_mask=torch.stack([c.example_mask for c in complexes]),
        contact_map=torch.stack([c.contact_map for c in complexes]),
    )
