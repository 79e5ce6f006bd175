"""Persistent inference engine: load once, capture per bucket, serve many.

Port of ``deepinteract_tpu/serving/engine.py`` for one card. A one-shot
``cli/predict.py`` process pays model construction and, on the card, one
Python dispatch per op of the forward for every complex. A serving process
pays the setup once and answers every request with one graph replay:

* **weights resident**: loaded once at construction (the best/ step of a
  ``--ckpt_name`` checkpoint, a JAX variables tree or ``.npz``, else the
  seeded init, as ``cli/predict.load_model``) and kept on the device;
* **shape-bucketed graph cache**: requests are padded to the loader's
  chain-length buckets (``data/loader.make_bucket_fn``), and one CUDA
  graph (``serving/graphs.py``) is captured per ``(bucket_n1, bucket_n2,
  per-graph shape signature, batch)`` key. A warm request captures
  nothing — pinned by :attr:`InferenceEngine.capture_count`;
* **bounded batch inventory**: coalesced groups are padded up to the next
  power-of-two batch size (duplicating a row, results discarded), so the
  inventory grows O(log max_batch) per bucket;
* **over-bucket complexes**: chains beyond the top bucket pad to
  top-bucket multiples with BOTH sides lifted to tile-size multiples, and
  the model is built with ``tile_pair_map`` so the decoder runs blockwise
  (``models/tiled.py``), inside the key's graph;
* **micro-batching**: concurrent ``submit()`` futures of the same bucket
  share one dispatch (``serving/scheduler.py``), and an LRU result cache
  (``serving/cache.py``) short-circuits repeated complexes.

* **split phase** (bulk screening, ``screening/``): the siamese forward
  split at ``DeepInteract.encode`` / ``decode``, as two more kinds of key
  in the same inventory: one graph per (chain bucket, shape signature,
  slots) encode and one per (bucket1, bucket2, slots) decode
  (:meth:`InferenceEngine.encode_executable`,
  :meth:`InferenceEngine.decode_executable`), so N chains cost N encodes
  and N^2 decodes instead of N^2 whole forwards.

On the CPU (``device="cpu"``) the same engine runs each dispatch eagerly
through the plain attention; nothing is captured there. On the card every
key is captured or the dispatch raises ``BatchExecutionError(stage=
"compile")``: no key is ever served eagerly. Every model configuration
captures (the GCN encoder, the DeepLab decoder, tiled decoding, regional
attention). The mesh placement and the tuning store of the JAX engine
are not ported.

``predict()`` is the blocking convenience wrapper over ``submit()``.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deepinteract_tpu_torch import constants
from deepinteract_tpu_torch.cli.predict import load_model
from deepinteract_tpu_torch.data.graph import ProteinGraph, stack_complexes
from deepinteract_tpu_torch.data.io import complex_lengths, to_paired_complex
from deepinteract_tpu_torch.data.loader import make_bucket_fn
from deepinteract_tpu_torch.data.synthetic import random_complex
from deepinteract_tpu_torch.device import resolve_device
from deepinteract_tpu_torch.models.model import ModelConfig
from deepinteract_tpu_torch.models.policy import set_backend_precision
from deepinteract_tpu_torch.obs import metrics as obs_metrics
from deepinteract_tpu_torch.robustness import faults
from deepinteract_tpu_torch.serving.admission import (
    AdmissionController,
    BatchExecutionError,
    Deadline,
    DeadlineExceeded,
    Overloaded,
    expired_counter,
)
from deepinteract_tpu_torch.serving.cache import ResultCache, content_hash
from deepinteract_tpu_torch.serving.fleet import batch_slots
from deepinteract_tpu_torch.serving.graphs import (decode_forward, encode_forward, make_entry,
                                                   serve_forward)
from deepinteract_tpu_torch.serving.scheduler import MicroBatchScheduler
from deepinteract_tpu_torch.weights import carried_signature, seeded_signature

logger = logging.getLogger(__name__)

# Registry counters are PROCESS-wide (/metrics scope) and parallel to the
# engine's per-instance attributes (/stats scope). The names are the JAX
# package's, so dashboards and the load shedder read either; "compile"
# is a CUDA graph capture here.
_EXECUTED_REQUESTS = obs_metrics.counter(
    "di_serving_executed_requests_total",
    "Requests answered by a device dispatch (cache hits excluded)")
_EXECUTED_BATCHES = obs_metrics.counter(
    "di_serving_executed_batches_total", "Coalesced device dispatches")
_PADDED_SLOTS = obs_metrics.counter(
    "di_serving_padded_slots_total",
    "Batch slots filled with padding rows (discarded work)")
_CACHE_HITS = obs_metrics.counter(
    "di_serving_result_cache_hits_total",
    "Requests short-circuited by the result cache")
_COMPILES = obs_metrics.counter(
    "di_serving_compiles_total",
    "Cold entries made (one CUDA graph capture per new bucket/batch key)")
_COMPILE_SECONDS = obs_metrics.histogram(
    "di_serving_compile_seconds", "Wall time of each cold capture")
# Load-shedder signal: >0 while a capture holds the exec lock.
_COMPILE_INFLIGHT = obs_metrics.gauge(
    "di_serving_compile_inflight", "Cold captures currently in progress")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Serving knobs (CLI surface: ``cli/serve.py``)."""

    # Micro-batching: flush a bucket's pending group at this many requests
    # or once its oldest request has waited max_delay_ms.
    max_batch: int = 8
    max_delay_ms: float = 5.0
    # Keys captured at startup, each (bucket_n1, bucket_n2, batch) — first
    # requests then replay warm graphs instead of paying a capture.
    warmup_buckets: Tuple[Tuple[int, int, int], ...] = ()
    # LRU result-cache entries (depadded probability maps); <= 0 disables.
    result_cache_size: int = 256
    # Bucket policy — the loader flags' semantics (cli/args.py): diagonal
    # pads both chains to the larger chain's bucket.
    diagonal_buckets: bool = False
    pad_to_max_bucket: bool = False
    # Zero all input features (the scientific-control path); part of the
    # result-cache key since it changes the output for the same upload.
    input_indep: bool = False
    # Overload bounds (serving/admission.py): per-bucket pending-queue
    # cap and global admitted-in-flight cap.
    max_queue_depth: int = 64
    max_inflight: int = 256


def _as_tensor(x) -> torch.Tensor:
    """A host array as a tensor; a read-only array (a cached embedding) is
    copied, since torch tensors cannot be read-only."""
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()
    return torch.as_tensor(x)


class InferenceEngine:
    """Resident model + shape-bucketed graph cache + micro-batcher.

    ``model_cfg`` defaults to the flagship ``ModelConfig``, with
    ``tile_pair_map`` forced on (a no-op for in-bucket shapes; required for
    the over-bucket tier). ``ckpt_dir`` is a checkpoint directory of the
    port's trainer (its best/ step is served), ``weights`` a flat-path
    ``.npz`` or a ``{"params", "batch_stats"}`` tree of JAX variables;
    with neither the engine serves the seeded init. ``device`` defaults
    to ``cuda`` (``device.resolve_device``: raises without a GPU)."""

    def __init__(
        self,
        model_cfg: Optional[ModelConfig] = None,
        ckpt_dir: Optional[str] = None,
        cfg: EngineConfig = EngineConfig(),
        seed: int = 42,
        metric_to_track: str = "val_ce",
        device=None,
        weights: Union[str, Mapping, None] = None,
    ):
        base = model_cfg or ModelConfig()
        self.device = resolve_device(device)
        self.cfg = cfg
        if not base.tile_pair_map:
            base = dataclasses.replace(base, tile_pair_map=True)
        self.model = load_model(base, self.device, weights, seed, ckpt_dir, metric_to_track)
        set_backend_precision(base.gnn.compute_dtype)
        self._tile = int(base.tile_size)
        self._base_bucket_fn = make_bucket_fn(cfg.pad_to_max_bucket, cfg.diagonal_buckets)

        # Graph cache: bucket/signature/batch key -> entry (serving/graphs.py).
        self._entries: Dict[Tuple, Any] = {}
        # Held for every capture AND every replay through the copy of its
        # output to the host: the entries share one memory pool, so a
        # replay may overwrite another key's output buffer.
        self._exec_lock = threading.Lock()
        # Inventory labels mirrored under their OWN tiny lock: /healthz
        # must answer while a capture holds _exec_lock. Nesting order is
        # _exec_lock -> _labels_lock only.
        self._warm_labels: Tuple[str, ...] = ()
        self._labels_lock = threading.Lock()
        # One per capture (on the CPU, per entry made), never per replay:
        # the warm-path guarantee is asserted on this counter.
        self.capture_count = 0
        self._executed_batches = 0
        self._executed_requests = 0
        self._padded_slots = 0
        self._started = time.time()
        self._pool = (torch.cuda.graph_pool_handle() if self.device.type == "cuda"
                      else None)

        self.cache = ResultCache(cfg.result_cache_size)
        self._seed = int(seed)
        if ckpt_dir:
            self.restored_from = ckpt_dir
        elif weights is not None:
            self.restored_from = carried_signature(self.model)
        else:
            self.restored_from = None
        if cfg.warmup_buckets:
            self.warmup(cfg.warmup_buckets)
        self.admission = AdmissionController(
            max_queue_depth=cfg.max_queue_depth,
            max_inflight=cfg.max_inflight)
        self.scheduler = MicroBatchScheduler(
            self._flush, max_batch=cfg.max_batch,
            max_delay_ms=cfg.max_delay_ms,
            admission=self.admission,
            on_expired=self._expired_in_queue)

    # -- shape policy ------------------------------------------------------

    def bucket_for(self, n1: int, n2: int) -> Tuple[int, int]:
        """Padded (bucket_n1, bucket_n2) for a request.

        In-bucket chains follow the loader's policy verbatim. Once either
        chain exceeds one tile the decoder runs tiled, and
        ``models/tiled.py:tile_grid`` requires BOTH padded lengths to be
        tile multiples — so the partner chain's bucket is lifted to the
        next tile multiple too (e.g. (300, 40) -> (512, 256) at tile 256)."""
        b1, b2 = self._base_bucket_fn(n1, n2)
        if b1 > self._tile or b2 > self._tile:
            lift = lambda b: ((b + self._tile - 1) // self._tile) * self._tile
            return lift(b1), lift(b2)
        return b1, b2

    def _batch_slots(self, n_requests: int) -> int:
        """Coalesced groups pad to the next power of two (capped at
        max_batch), so the per-bucket inventory stays O(log max_batch)."""
        return batch_slots(n_requests, self.cfg.max_batch)

    def _bucket_key(self, raw: Dict) -> Tuple:
        """A request's scheduler key: its (bucket_n1, bucket_n2) and the
        per-graph shape signature. A graph-cache key adds the batch slots."""
        return self.bucket_for(*complex_lengths(raw)) + self._shape_signature(raw)

    def _assemble(self, raws: Sequence[Dict], bucket_key: Tuple):
        """The stacked host batch of one dispatch, and its batch slots: each
        complex padded to the key's buckets, the group padded up to the
        slots with copies of its first complex (their results discarded)."""
        b1, b2 = bucket_key[0], bucket_key[1]
        complexes = [to_paired_complex(raw, n_pad1=b1, n_pad2=b2,
                                       input_indep=self.cfg.input_indep) for raw in raws]
        slots = self._batch_slots(len(complexes))
        return stack_complexes(complexes + [complexes[0]] * (slots - len(complexes))), slots

    # -- graph cache -------------------------------------------------------

    def weights_signature(self) -> str:
        """Identity of the served weights (what /healthz advertises, and
        what embedding keys, indexes and calibrations are bound to)."""
        return self.restored_from or seeded_signature(self._seed)

    def warm_bucket_labels(self) -> list:
        """Sorted inventory labels (the ``compiled_buckets`` keys of
        :meth:`stats`) from the NON-BLOCKING mirror."""
        with self._labels_lock:
            return list(self._warm_labels)

    def _entry(self, key: Tuple, inputs: Tuple, fn=serve_forward):
        """The key's entry; a cold key is captured from ``fn(model,
        *inputs)`` (its shapes, and the data of the warm-up runs). The
        caller holds ``_exec_lock``. A failed capture raises
        ``BatchExecutionError(stage="compile")``."""
        entry = self._entries.get(key)
        if entry is not None:
            return entry
        _COMPILE_INFLIGHT.inc()
        try:
            entry = make_entry(self.model, inputs, self._pool, fn)
        except Exception as exc:
            raise BatchExecutionError(f"CUDA graph capture of {self._key_label(key)} "
                                      f"failed: {exc}", stage="compile") from exc
        finally:
            _COMPILE_INFLIGHT.dec()
        self._entries[key] = entry
        self.capture_count += 1
        with self._labels_lock:
            self._warm_labels = tuple(sorted(map(self._key_label, self._entries)))
        _COMPILES.inc()
        _COMPILE_SECONDS.observe(entry.seconds)
        return entry

    @staticmethod
    def _key_label(key: Tuple) -> str:
        """The JAX engine's inventory labels: ``{b1}x{b2}/b{slots}/k{K}g{G}``
        for a request key, ``enc:{bucket}/b{slots}/k{K}g{G}`` and
        ``dec:{b1}x{b2}/b{slots}`` for the split phase."""
        if key[0] == "enc":
            _, bucket, sig, slots = key
            return f"enc:{bucket}/b{slots}/k{sig[0]}g{sig[1]}"
        if key[0] == "dec":
            return "dec:{}x{}/b{}".format(*key[1:])
        b1, b2, sig1, sig2, bs = key
        label = f"{b1}x{b2}/b{bs}/k{sig1[0]}g{sig1[1]}"
        if sig2 != sig1:
            label += f"/k2_{sig2[0]}g2_{sig2[1]}"
        return label

    def normalize_warmup(self, b1: int, b2: int, bs: int) -> Tuple[int, int, int]:
        """Map an operator warmup spec onto a key the REQUEST PATH can hit:
        buckets through :meth:`bucket_for` and batch through
        :meth:`_batch_slots`. Without this, ``--warmup_buckets 128x128x6``
        would capture a graph no request could look up."""
        nb1, nb2 = self.bucket_for(b1, b2)
        return nb1, nb2, self._batch_slots(bs)

    def warmup(self, buckets: Sequence[Tuple[int, int, int]],
               knn: int = constants.KNN,
               geo: int = constants.GEO_NBRHD_SIZE) -> None:
        """Capture the given (bucket_n1, bucket_n2, batch) keys now, so
        startup (not the first unlucky client) pays the captures. Specs are
        normalized onto reachable keys (see :meth:`normalize_warmup`)."""
        rng = np.random.default_rng(0)
        for spec in buckets:
            b1, b2, bs = self.normalize_warmup(*spec)
            # Chains must exceed knn for the synthetic featurizer; the
            # captured shapes depend only on the padded sizes.
            one = random_complex(min(b1, knn + 1), min(b2, knn + 1), rng=rng,
                                 n_pad1=b1, n_pad2=b2, knn=knn, geo_nbrhd_size=geo)
            batch = stack_complexes([one] * bs)
            sig = tuple(
                (int(g.nbr_idx.shape[-1]), int(g.src_nbr_eids.shape[-1]),
                 int(g.node_feats.shape[-1]), int(g.edge_feats.shape[-1]))
                for g in (one.graph1, one.graph2))
            with self._exec_lock:
                self._entry((b1, b2) + sig + (bs,), (batch.graph1, batch.graph2))

    # -- split phase (bulk screening) --------------------------------------
    #
    # The model is siamese (one shared-weight encoder leg per chain), so an
    # N-chain all-vs-all screen needs N encoder passes and N^2 cheap
    # decodes, not N^2 whole forwards. These two kinds of entry are the
    # served forward split at DeepInteract.encode / decode: composed, they
    # give its probabilities bitwise on the same batch. The screening
    # runners bypass the micro-batch scheduler (as in the JAX package) and
    # share the exec lock with it, never the pool: an entry's output is
    # copied to the host under the lock (replay_to_host).

    def chain_bucket(self, n: int) -> int:
        """Padded bucket for a LONE chain under this engine's bucket policy
        (the split-phase analog of :meth:`bucket_for`, tile lift included)."""
        return self.bucket_for(n, n)[0]

    def encode_executable(self, bucket: int, sig: Tuple, slots: int, graph_batch):
        """The entry of one chain-bucket encode over a ``[slots, bucket,
        ...]`` stacked graph batch (``sig``: knn, geo, node and edge
        feature widths); its replay gives ``[slots, bucket, C]`` float32
        features. Captured once per key from ``graph_batch``."""
        with self._exec_lock:
            return self._entry(("enc", int(bucket), tuple(sig), int(slots)),
                               (graph_batch,), encode_forward)

    def decode_executable(self, b1: int, b2: int, slots: int, args: Tuple):
        """The entry of one (bucket1, bucket2, slots) decode; ``args`` is
        (feats1 [slots, b1, C] float32, feats2, mask1 [slots, b1] bool,
        mask2) at the padded shapes. Its replay gives ``[slots, b1, b2]``
        probabilities; over-bucket pairs decode tiled, as
        ``DeepInteract.decode`` does."""
        with self._exec_lock:
            return self._entry(("dec", int(b1), int(b2), int(slots)),
                               tuple(map(_as_tensor, args)), decode_forward)

    def replay_to_host(self, entry, *inputs) -> np.ndarray:
        """Replay a split-phase entry on ``inputs`` and copy its output to
        the host under the exec lock: entries share one memory pool, so an
        output is valid only until the next replay of any key."""
        inputs = tuple(x if isinstance(x, ProteinGraph) else _as_tensor(x) for x in inputs)
        with self._exec_lock:
            return entry.replay(*inputs).cpu().numpy()

    # -- request path ------------------------------------------------------

    @staticmethod
    def _shape_signature(raw: Dict) -> Tuple:
        """Everything BESIDES the padded lengths that fixes a key's shapes,
        per graph: (knn, geo, node-feature width, edge-feature width).
        graph2's dims are included independently, so an asymmetric upload
        never shares a batch (or a graph) with a symmetric one."""
        sig = []
        for g in (raw["graph1"], raw["graph2"]):
            sig.append((int(g["nbr_idx"].shape[1]),
                        int(g["src_nbr_eids"].shape[2]),
                        int(g["node_feats"].shape[1]),
                        int(g["edge_feats"].shape[2])))
        return tuple(sig)

    def _expired_in_queue(self, payload: Dict, deadline) -> Exception:
        """Scheduler ``on_expired`` hook: the typed failure for a
        deadline-swept request, with its trace decomposition attached
        (``device_ms == 0`` by construction — it never dispatched)."""
        trace = None
        rt = payload.get("reqtrace")
        if rt is not None:
            rt.set_phase("queue_wait", rt.since("submit"))
            trace = rt.finish(deadline=deadline.budget_s,
                              deadline_remaining=0.0)
        return DeadlineExceeded(
            f"deadline ({deadline.budget_s * 1e3:.0f}ms) expired while "
            "queued; dropped before batch assembly", trace=trace)

    def submit(self, raw: Dict, reqtrace=None,
               deadline: Optional[Deadline] = None) -> Future:
        """Future-returning enqueue. ``raw`` is a loaded complex dict
        (``data/io.py`` schema: graph1/graph2/examples). ``reqtrace`` is
        an optional :class:`deepinteract_tpu_torch.obs.reqtrace.RequestTrace`
        carried through the scheduler queue to the flush; when given, the
        result dict gains a ``trace`` decomposition (queue-wait /
        assembly / compile / device) under the request's ``trace_id``.
        ``deadline`` is checked here, at the scheduler's batch-assembly
        sweep, and bounds ``predict``'s wait.

        Raises ``Overloaded`` (bounded queues full, with ``retry_after_s``)
        or ``DeadlineExceeded`` (already expired at admission); the future
        can additionally fail with either plus
        ``BatchExecutionError``/``ShuttingDown``.

        Result contract: ``probs`` is a READ-ONLY array (it may be shared
        with the result cache) — ``.copy()`` it before mutating."""
        faults.maybe_raise(
            "serving.admission",
            lambda: Overloaded("injected admission fault",
                               retry_after_s=self.admission.retry_after_s()))
        if deadline is not None and deadline.expired:
            expired_counter("admission")
            raise DeadlineExceeded(
                f"deadline ({deadline.budget_s * 1e3:.0f}ms) already "
                "expired at admission")
        key = None
        if self.cache.capacity > 0:  # don't hash MBs for a disabled cache
            key = content_hash(raw, extra=("input_indep", self.cfg.input_indep))
            hit = self.cache.get(key)
            if hit is not None:
                _CACHE_HITS.inc()
                fut: Future = Future()
                result = dict(hit, cached=True)
                if reqtrace is not None:
                    # A hit never queues or touches the device.
                    result["trace"] = reqtrace.finish(cached=True)
                fut.set_result(result)
                return fut
        n1, n2 = complex_lengths(raw)
        if reqtrace is not None:
            reqtrace.mark("submit")
        return self.scheduler.submit(
            self._bucket_key(raw),
            {"raw": raw, "n1": n1, "n2": n2, "cache_key": key,
             "reqtrace": reqtrace, "deadline": deadline},
            deadline=deadline,
        )

    def predict(self, raw: Dict, timeout: Optional[float] = None,
                reqtrace=None, deadline: Optional[Deadline] = None) -> Dict:
        """Blocking single-complex prediction through the same batched
        path. With a ``deadline`` the wait is bounded by it (plus a small
        grace for the scheduler's sweep to answer)."""
        fut = self.submit(raw, reqtrace=reqtrace, deadline=deadline)
        if deadline is not None:
            bound = deadline.remaining_s() + 0.25
            timeout = bound if timeout is None else min(timeout, bound)
            try:
                return fut.result(timeout=timeout)
            except FuturesTimeout:
                expired_counter("wait")
                raise DeadlineExceeded(
                    f"deadline ({deadline.budget_s * 1e3:.0f}ms) expired "
                    "while waiting for the result") from None
        return fut.result(timeout=timeout)

    def _flush(self, bucket_key, items) -> list:
        """One coalesced dispatch for same-bucket requests — runs on the
        scheduler's worker thread. ``bucket_key`` is (b1, b2) plus the
        per-graph shape signature (see :meth:`_shape_signature`).

        Request-trace phases (batch-shared): dequeue closes queue_wait,
        then assembly (pad/stack, on the host), then graph acquisition
        (compile — the capture of a cold key, ≈0 warm), then replay and
        the copy of the probabilities to the host (device)."""
        traces = [it.get("reqtrace") for it in items]
        t_dequeue = time.perf_counter()
        for rt in traces:
            if rt is not None:
                rt.set_phase("queue_wait", rt.since("submit"))
        b1, b2 = bucket_key[0], bucket_key[1]
        try:
            faults.maybe_raise(
                "serving.assembly",
                lambda: BatchExecutionError("injected batch-assembly fault",
                                            stage="assembly"))
            batch, slots = self._assemble([it["raw"] for it in items], bucket_key)
        except BatchExecutionError:
            raise
        except Exception as exc:
            raise BatchExecutionError(
                f"batch assembly failed: {exc}", stage="assembly") from exc
        pad_slots = slots - len(items)
        t_assembled = time.perf_counter()
        with self._exec_lock:
            entry = self._entry(tuple(bucket_key) + (slots,), (batch.graph1, batch.graph2))
            t_compiled = time.perf_counter()
            try:
                faults.maybe_raise(
                    "serving.dispatch",
                    lambda: BatchExecutionError("injected device-dispatch fault",
                                                stage="dispatch"))
                probs = entry.replay(batch.graph1, batch.graph2).cpu().numpy()
            except BatchExecutionError:
                raise
            except Exception as exc:
                # Typed so clients can tell "your batch died" from "your
                # upload was bad"; the scheduler fails ONLY this group.
                raise BatchExecutionError(
                    f"device dispatch failed: {exc}", stage="dispatch") from exc
            t_fetched = time.perf_counter()
            self._executed_batches += 1
            self._executed_requests += len(items)
            self._padded_slots += pad_slots
        for rt in traces:
            if rt is not None:
                rt.set_phase("batch_assembly", t_assembled - t_dequeue)
                rt.set_phase("compile", t_compiled - t_assembled)
                rt.set_phase("device", t_fetched - t_compiled)
        _EXECUTED_BATCHES.inc()
        _EXECUTED_REQUESTS.inc(len(items))
        _PADDED_SLOTS.inc(pad_slots)
        results = []
        for i, it in enumerate(items):
            depadded = probs[i, : it["n1"], : it["n2"]].copy()
            # Shared with the cache: read-only, so a client mutating it in
            # place fails loudly instead of corrupting later hits.
            depadded.setflags(write=False)
            result = {
                "probs": depadded,
                "n1": it["n1"],
                "n2": it["n2"],
                "bucket": (b1, b2),
                "batch_slots": slots,
                "coalesced": len(items),
                "cached": False,
            }
            if it["cache_key"] is not None:
                # The cache holds its OWN dict (sharing only the immutable
                # array), snapshotted before the trace block is attached.
                self.cache.put(it["cache_key"], dict(result))
            rt = traces[i]
            if rt is not None:
                extra = {}
                dl = it.get("deadline")
                if dl is not None:
                    extra = {"deadline": dl.budget_s,
                             "deadline_remaining": dl.remaining_s()}
                result["trace"] = rt.finish(coalesced=len(items), **extra)
            results.append(result)
        return results

    # -- lifecycle / observability ----------------------------------------

    def close(self, timeout: float = 60.0) -> bool:
        """Drain the scheduler: flush every pending request, then stop
        accepting. False = the drain timed out with work still in flight."""
        return self.scheduler.drain(timeout=timeout)

    def stats(self) -> Dict[str, Any]:
        with self._exec_lock:
            entries = {self._key_label(key): entry for key, entry in self._entries.items()}
            compiled = {label: entry.seconds for label, entry in entries.items()}
            inventory = {label: {
                "seconds": round(entry.seconds, 3),
                "replays": entry.replays,
                "k1_launches": entry.k1_launches,
                "k2_launches": entry.k2_launches,
                "csr_builds": entry.csr_builds,
            } for label, entry in entries.items()}
            capture_count = self.capture_count
            executed_batches = self._executed_batches
            executed_requests = self._executed_requests
            padded_slots = self._padded_slots
        return {
            "uptime_seconds": time.time() - self._started,
            "restored_from": self.restored_from,
            "device": (torch.cuda.get_device_name(self.device)
                       if self.device.type == "cuda" else str(self.device)),
            "interaction_stem": self.model.cfg.interaction_stem,
            "compute_dtype": {
                "gnn": self.model.cfg.gnn.compute_dtype,
                "decoder": self.model.cfg.decoder.compute_dtype,
            },
            "capture_count": capture_count,
            "compiled_buckets": compiled,
            "compile_inventory": inventory,
            "num_compiled_executables": len(compiled),
            "executed_batches": executed_batches,
            "executed_requests": executed_requests,
            "padded_slots": padded_slots,
            "scheduler": self.scheduler.stats(),
            "admission": self.admission.stats(),
            "result_cache": self.cache.stats(),
        }
