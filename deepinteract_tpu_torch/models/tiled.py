"""Blockwise (tiled) pair-map decoding, the long-context tier.

Port of ``deepinteract_tpu/models/tiled.py``: the reference's
"subsequencing". Chains past one tile split into tile-size blocks, every
(block, block) pair of the grid runs through the decoder as an
independent map (its own instance-norm, SE and pooling statistics, as the
reference's per-tile passes), and the tiles are put back into the
L1 x L2 map. Tiled logits therefore differ from an untiled decode of the
same complex.

The JAX package's ``nn.scan`` over tile indices is a Python loop here, in
row-major order (tile ``idx`` is ``(idx // n2, idx % n2)``). The decoder's
parameters are shared by every tile; in train mode each tile's dropout
draws from its own stream of the step's key, forked by the tile index.

With a pair mesh (``parallel/pair.py``; the JAX ``shard_pair_axis``) the
grid stays a sequential loop in the same order and each tile's rows split
over the pair group: the rank decodes its run of every tile's rows and
returns them stacked by tile row (``parallel.pair.row_slices`` with one
block per tile row).
"""

from __future__ import annotations

import torch
from torch import nn

from deepinteract_tpu_torch.models.interaction import interaction_tensor
from deepinteract_tpu_torch.models.layers import Dropout
from deepinteract_tpu_torch.models.stem import PairFactors, shard_pair_rows
from deepinteract_tpu_torch.parallel.pair import row_slices


def tile_grid(l1: int, l2: int, tile: int) -> tuple:
    """(tile rows, tile columns) of a padded l1 x l2 map; raises unless both
    lengths are multiples of ``tile``."""
    if l1 % tile or l2 % tile:
        raise ValueError(f"padded chain lengths ({l1}, {l2}) must be multiples of the "
                         f"tile size {tile}; pick buckets accordingly")
    return l1 // tile, l2 // tile


def tiled_decode(decoder: nn.Module, feats1: torch.Tensor, feats2: torch.Tensor,
                 mask1: torch.Tensor, mask2: torch.Tensor, tile: int,
                 stem: str = "factorized", pair=None) -> torch.Tensor:
    """Decode the [B, L1, L2] pair map in tile x tile blocks.

    ``decoder``: the model's ``InteractionDecoder`` or ``DeepLabDecoder``;
    ``feats1`` / ``feats2``: [B, L1, C] / [B, L2, C] encoded chains;
    ``mask1`` / ``mask2``: [B, L1] / [B, L2] bool node masks. ``stem``
    'factorized' hands each tile to the decoder as ``PairFactors``;
    'materialized' builds the tile's [B, T, T, 2C] tensor. Returns
    [B, L1, L2, num_classes] float32 logits, zero at padded pairs; with a
    ``pair`` mesh, this rank's rows of them (``[B, n1 * T / P, L2, K]``).
    The dilated decoder alone takes a pair mesh."""
    b, l1, _ = feats1.shape
    l2 = feats2.shape[1]
    n1, n2 = tile_grid(l1, l2, tile)
    # This rank's run of each tile's rows (None: the whole tile).
    mine = (None if pair is None else row_slices(tile, pair, 1, decoder.halo_rows()))
    own_rows = tile if mine is None else mine[0].stop - mine[0].start
    drops = [m for m in decoder.modules() if isinstance(m, Dropout)]
    step_key = drops[0].key if drops else None
    tiles = []
    try:
        for idx in range(n1 * n2):
            ti, tj = divmod(idx, n2)
            rows, cols = slice(ti * tile, (ti + 1) * tile), slice(tj * tile, (tj + 1) * tile)
            f1, f2 = feats1[:, rows], feats2[:, cols]
            m1, m2 = mask1[:, rows], mask2[:, cols]
            if mine is not None:
                f1, m1 = shard_pair_rows(f1, mine), shard_pair_rows(m1, mine)
            pm = m1[:, :, None] & m2[:, None, :]
            pair_input = (PairFactors(f1, f2, m1, m2) if stem == "factorized"
                          else interaction_tensor(f1, f2))
            if step_key is not None:
                tile_key = step_key.fork(idx)
                for d in drops:
                    d.key = tile_key
            tiles.append(decoder(pair_input, pm) if pair is None
                         else decoder(pair_input, pm, pair))
    finally:
        for d in drops:
            d.key = step_key
    k = tiles[0].shape[-1]
    out = torch.stack(tiles).reshape(n1, n2, b, own_rows, tile, k)
    return out.permute(2, 0, 3, 1, 4, 5).reshape(b, n1 * own_rows, l2, k)
