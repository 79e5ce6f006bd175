"""Bucketing batch loader.

Port of the planning and iteration of ``deepinteract_tpu/data/loader.py``.
Complexes are grouped by their (bucket1, bucket2) padded chain lengths
(``pick_bucket`` over ``constants.CHAIN_LENGTH_BUCKETS``) and only
same-bucket complexes batch together, so a batch stacks without ragged
edges. The epoch plan (bucket order, seeded shuffle, ``drop_remainder``)
is the JAX loader's, batch for batch: with ``dispatch_run`` K > 1 each
bucket's batches are cut into runs of up to K and whole runs are
shuffled, so the trainer's K-step dispatches (``training/loop.py``) see
same-shape runs; ``cli.train`` passes ``max(1, --steps_per_dispatch)`` as
the JAX CLI does. A :class:`~deepinteract_tpu_torch.data.packed.PackedDataset`
is planned by its pack-time buckets and read by mmap + stack. Batches
are CPU tensors, assembled ``prefetch`` ahead of the consumer on a
daemon thread (0: inline); the trainer's placement stage
(``data/pipeline.py``) moves them to its device.

Resume cursor: ``iter_epoch(epoch, start_batch, skips_used)`` starts an
epoch at a consumed-batch position without loading the batches before it,
and ``skip_budget`` lets up to that many batches per epoch fail to load
(logged, dropped) before a load error is raised; ``skips_before`` is the
trainer's ledger of those drops.

Data parallel (``shard=(rank, world)``, the JAX loader's): every rank
plans the same global batches of ``batch_size * world`` over the whole
dataset from the same seed and loads only its own ``batch_size`` slice of
each, so ranks agree on steps and batch shapes by construction (a split
file list would not); a short global batch wraps within its bucket, and
``num_batches`` counts global steps. Under a multi-process group a skip
drop is decided by host 0 through ``parallel.multihost.agree_any_flag``
(the store, safe on the read-ahead thread), so every rank drops the same
batches.
"""

from __future__ import annotations

import logging
import queue
import random
import threading
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

from deepinteract_tpu_torch import constants
from deepinteract_tpu_torch.data.graph import PairedComplex, pick_bucket, stack_complexes
from deepinteract_tpu_torch.data.io import to_paired_complex
from deepinteract_tpu_torch.robustness import faults

logger = logging.getLogger(__name__)


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
                 pad_to_max_bucket: bool = False, diagonal_buckets: bool = False,
                 skip_budget: int = 0, prefetch: int = 2, dispatch_run: int = 1,
                 shard: Optional[Tuple[int, int]] = None):
        if shard is not None and not 0 <= shard[0] < shard[1]:
            raise ValueError(f"shard {shard}: expected (rank, world) with 0 <= rank < world")
        self.dataset = dataset
        # (rank, world): this rank's slice of each global batch.
        self.shard = shard
        # Per-produce serial of the skip agreement's keys (write-once per
        # key; ranks produce epochs in the same order).
        self._agree_serial = 0
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.seed = seed
        # Batches assembled ahead of the consumer on a daemon thread (npz
        # load, pad and stack overlap the device's work); 0 loads inline.
        self.prefetch = prefetch
        # Shuffle granularity: runs of up to this many consecutive
        # same-bucket batches stay together and whole runs are shuffled.
        self.dispatch_run = max(1, dispatch_run)
        # Batches per epoch that may fail to load and be dropped (the whole
        # batch: a smaller one would change shapes); over budget the load
        # error is raised. 0 fails fast.
        self.skip_budget = max(0, skip_budget)
        # Cumulative drops at each consumed-batch ordinal of the epoch being
        # iterated: the trainer's resume ledger.
        self._skips_at: Dict[int, int] = {}
        bucket_fn = make_bucket_fn(pad_to_max_bucket, diagonal_buckets)
        # A pack fixed each item's bucket when it was written: planning by
        # the stored buckets keeps plan and pack consistent.
        bucket_of = getattr(dataset, "bucket_of", None)
        buckets: Dict[Tuple[int, int], List[int]] = defaultdict(list)
        for idx, (n1, n2) in enumerate(dataset.lengths()):
            key = tuple(bucket_of(idx)) if bucket_of is not None else bucket_fn(n1, n2)
            buckets[key].append(idx)
        self._buckets = dict(buckets)

    def _global_batch_size(self) -> int:
        return self.batch_size * (self.shard[1] if self.shard else 1)

    def num_batches(self) -> int:
        """Batches an epoch plans: global steps under a shard."""
        gb, total = self._global_batch_size(), 0
        for indices in self._buckets.values():
            total += len(indices) // gb if self.drop_remainder else -(-len(indices) // gb)
        return total

    def epoch_plan(self, epoch: int) -> List[Tuple[Tuple[int, int], List[int]]]:
        """[(bucket, item indices)] in this epoch's batch order: buckets in
        sorted order, items shuffled within each bucket, then the batches
        (or, with ``dispatch_run`` > 1, runs of up to that many same-bucket
        batches) shuffled, all from ``random.Random(seed + epoch)``. Under
        a shard the entries are global batches, the same on every rank."""
        plan = []
        gb = self._global_batch_size()
        rng = random.Random(self.seed + epoch) if self.shuffle else None
        for bucket, indices in sorted(self._buckets.items()):
            idxs = list(indices)
            if rng:
                rng.shuffle(idxs)
            for i in range(0, len(idxs), gb):
                chunk = idxs[i:i + gb]
                if len(chunk) < gb:
                    if self.drop_remainder:
                        continue
                    if self.shard:
                        # Wrap within the bucket (DistributedSampler padding):
                        # every rank's slice stays full.
                        chunk += [idxs[k % len(idxs)] for k in range(gb - len(chunk))]
                plan.append((bucket, chunk))
        if rng and self.dispatch_run > 1:
            runs, i = [], 0
            while i < len(plan):
                j = i
                while j < len(plan) and plan[j][0] == plan[i][0] and j - i < self.dispatch_run:
                    j += 1
                runs.append(plan[i:j])
                i = j
            rng.shuffle(runs)
            plan = [entry for run in runs for entry in run]
        elif rng:
            rng.shuffle(plan)
        return plan

    def skips_before(self, batches_consumed: int) -> int:
        """Batches dropped by the skip budget before the given consumed-batch
        ordinal of the epoch last iterated."""
        if batches_consumed <= 0:
            return 0
        return int(self._skips_at.get(int(batches_consumed), 0))

    def _host_slice(self, chunk: List[int]) -> List[int]:
        if self.shard is None:
            return chunk
        start = self.shard[0] * self.batch_size
        return chunk[start:start + self.batch_size]

    def _skip_agreement(self):
        """None for one process or no skip budget (local decisions), else
        ``(epoch, plan_pos, local_fail) -> drop``: host 0's verdict "some
        rank failed to load this plan entry". A multi-process group
        without the store raises rather than risk ranks dropping
        different batches."""
        from deepinteract_tpu_torch.parallel import multihost

        if self.shard is None or self.skip_budget <= 0 or multihost.process_count() <= 1:
            return None
        if not multihost.can_agree():
            raise RuntimeError("a multi-process skip_budget needs initialize_distributed's "
                               "store: set skip_budget=0 rather than risk ranks skipping "
                               "different batches")
        self._agree_serial += 1
        serial = self._agree_serial

        def agree(epoch: int, plan_pos: int, local_fail: bool) -> bool:
            return multihost.agree_any_flag(
                f"di_loader_skip/{self.seed}/{serial}/{epoch}/{plan_pos}", local_fail)

        return agree

    def _load(self, bucket: Tuple[int, int], chunk: List[int]) -> PairedComplex:
        faults.maybe_raise("loader.batch", lambda: ValueError("injected corrupt complex"))
        padded_batch = getattr(self.dataset, "padded_batch", None)
        if padded_batch is not None:
            return padded_batch(chunk, bucket)
        b1, b2 = bucket
        raws = [self.dataset[idx] for idx in chunk]
        return stack_complexes([
            to_paired_complex(raw, n_pad1=b1, n_pad2=b2,
                              input_indep=raw.get("input_indep", False))
            for raw in raws])

    def iter_epoch(self, epoch: int = 0, start_batch: int = 0,
                   skips_used: int = 0) -> Iterator[PairedComplex]:
        """The epoch's batches from consumed-batch ``start_batch`` on, with
        ``skips_used`` of the budget already spent before it: the first
        ``start_batch + skips_used`` plan entries were paid before a
        checkpoint and are passed over unloaded (the plan is fixed by seed
        and epoch). Read ``prefetch`` ahead on a daemon thread."""
        source = self._produce(epoch, start_batch, skips_used)
        if self.prefetch <= 0:
            return source
        return _prefetched(source, self.prefetch)

    def _produce(self, epoch: int, start_batch: int,
                 skips_used: int) -> Iterator[PairedComplex]:
        skips_left = self.skip_budget - max(0, skips_used)
        paid = max(0, start_batch) + max(0, skips_used)
        produced, cum_skips = max(0, start_batch), max(0, skips_used)
        self._skips_at = {}
        agree = self._skip_agreement()
        for pos, (bucket, chunk) in enumerate(self.epoch_plan(epoch)):
            if pos < paid:
                continue
            chunk = self._host_slice(chunk)
            local_exc: Optional[Exception] = None
            try:
                batch = self._load(bucket, chunk)
            except Exception as exc:
                if skips_left <= 0 and agree is None:
                    raise
                local_exc = exc
            drop = (agree(epoch, pos, local_exc is not None) if agree is not None
                    else local_exc is not None)
            if drop:
                if skips_left <= 0:
                    if local_exc is not None:
                        raise local_exc
                    raise RuntimeError(f"a peer rank failed to load batch (bucket "
                                       f"{bucket[0]}x{bucket[1]}, plan entry {pos}) with the "
                                       "skip budget exhausted")
                skips_left -= 1
                cum_skips += 1
                logger.warning("skipping corrupt batch (bucket %sx%s, items %s): %s - %d "
                               "skip(s) left this epoch", *bucket, chunk,
                               local_exc if local_exc is not None
                               else "a peer rank's load failure (coordinated drop)",
                               skips_left)
                continue
            if local_exc is not None:
                raise local_exc  # unreachable under the OR verdict: never yield None
            produced += 1
            self._skips_at[produced] = cum_skips
            yield batch

    def targets(self) -> List[str]:
        """Target names in epoch-0 order (for the test CSV): this rank's
        slices under a shard."""
        return [self.dataset.target_of(i) for _, chunk in self.epoch_plan(0)
                for i in self._host_slice(chunk)]

    def __call__(self, epoch: int) -> Iterator[PairedComplex]:
        return self.iter_epoch(epoch)

    def __iter__(self) -> Iterator[PairedComplex]:
        return self.iter_epoch(0)


def _prefetched(source: Iterator, depth: int) -> Iterator:
    """Run ``source`` on a daemon thread with up to ``depth`` items ready.
    Its exceptions re-raise on the consumer's side. A consumer that
    abandons the iterator (break, an exception, garbage collection) sets
    the stop flag the worker polls, so the thread ends instead of blocking
    on a full queue."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()

    def put_guarded(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in source:
                if not put_guarded(item):
                    return
        except BaseException as exc:  # noqa: BLE001 - re-raised on the consumer's side
            put_guarded((done, exc))
            return
        put_guarded((done, None))

    threading.Thread(target=worker, daemon=True, name="di-loader").start()
    try:
        while True:
            item = q.get()
            if isinstance(item, tuple) and len(item) == 2 and item[0] is done:
                if item[1] is not None:
                    raise item[1]
                return
            yield item
    finally:
        stop.set()
