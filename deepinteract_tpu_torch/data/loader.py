"""Bucketing batch loader.

Port of the planning and iteration of ``deepinteract_tpu/data/loader.py``.
Complexes are grouped by their (bucket1, bucket2) padded chain lengths
(``pick_bucket`` over ``constants.CHAIN_LENGTH_BUCKETS``) and only
same-bucket complexes batch together, so a batch stacks without ragged
edges. The epoch plan (bucket order, seeded shuffle, ``drop_remainder``)
is the JAX loader's with per-step dispatch (``dispatch_run=1``), batch
for batch. Batches are CPU tensors; the trainer
moves them to its device.
"""

from __future__ import annotations

import random
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

from deepinteract_tpu_torch import constants
from deepinteract_tpu_torch.data.graph import PairedComplex, pick_bucket, stack_complexes
from deepinteract_tpu_torch.data.io import to_paired_complex


def make_bucket_fn(pad_to_max_bucket: bool = False, diagonal_buckets: bool = False):
    """(n1, n2) -> (bucket1, bucket2) under the loader's bucketing flags:
    every chain padded to at least the top bucket, or both chains to the
    larger chain's bucket, or each to its own."""
    def bucket_fn(n1: int, n2: int) -> Tuple[int, int]:
        if pad_to_max_bucket:
            top = constants.CHAIN_LENGTH_BUCKETS[-1]
            return (max(pick_bucket(n1), top), max(pick_bucket(n2), top))
        if diagonal_buckets:
            b = max(pick_bucket(n1), pick_bucket(n2))
            return (b, b)
        return (pick_bucket(n1), pick_bucket(n2))
    return bucket_fn


class BucketedLoader:
    """Iterable of stacked ``PairedComplex`` batches. Calling it with an
    epoch number gives that epoch's (re-shuffled) iterator; iterating the
    object uses epoch 0."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_remainder: bool = False, seed: int = 42,
                 pad_to_max_bucket: bool = False, diagonal_buckets: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.seed = seed
        bucket_fn = make_bucket_fn(pad_to_max_bucket, diagonal_buckets)
        buckets: Dict[Tuple[int, int], List[int]] = defaultdict(list)
        for idx, (n1, n2) in enumerate(dataset.lengths()):
            buckets[bucket_fn(n1, n2)].append(idx)
        self._buckets = dict(buckets)

    def num_batches(self) -> int:
        gb, total = self.batch_size, 0
        for indices in self._buckets.values():
            total += len(indices) // gb if self.drop_remainder else -(-len(indices) // gb)
        return total

    def epoch_plan(self, epoch: int) -> List[Tuple[Tuple[int, int], List[int]]]:
        """[(bucket, item indices)] in this epoch's batch order: buckets in
        sorted order, items shuffled within each bucket and the batches
        interleaved, both from ``random.Random(seed + epoch)``."""
        plan = []
        rng = random.Random(self.seed + epoch) if self.shuffle else None
        for bucket, indices in sorted(self._buckets.items()):
            idxs = list(indices)
            if rng:
                rng.shuffle(idxs)
            for i in range(0, len(idxs), self.batch_size):
                chunk = idxs[i:i + self.batch_size]
                if len(chunk) < self.batch_size and self.drop_remainder:
                    continue
                plan.append((bucket, chunk))
        if rng:
            rng.shuffle(plan)
        return plan

    def iter_epoch(self, epoch: int = 0) -> Iterator[PairedComplex]:
        for (b1, b2), chunk in self.epoch_plan(epoch):
            raws = [self.dataset[idx] for idx in chunk]
            yield stack_complexes([
                to_paired_complex(raw, n_pad1=b1, n_pad2=b2,
                                  input_indep=raw.get("input_indep", False))
                for raw in raws])

    def targets(self) -> List[str]:
        """Target names in epoch-0 order (for the test CSV)."""
        return [self.dataset.target_of(i) for _, chunk in self.epoch_plan(0) for i in chunk]

    def __call__(self, epoch: int) -> Iterator[PairedComplex]:
        return self.iter_epoch(epoch)

    def __iter__(self) -> Iterator[PairedComplex]:
        return self.iter_epoch(0)

