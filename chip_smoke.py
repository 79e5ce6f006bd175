"""Chip smoke run of the PyTorch/CUDA port (``deepinteract_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero:
  1. device and toolchain (card, power limit, CUDA, nvcc, triton);
  2. build of every hand-written kernel from the sources in this checkout
     (one nvcc per source, started together);
  3. kernel parity on the card: the in-edge CSR against a CPU stable
     argsort; each kernel's wrapper against its plain PyTorch version at
     the main paths' shapes (flagship f32 and bf16, de=None, a hub
     destination with over 1,000 in-edges, the N=512 and N=768 buckets,
     a node without in-edges, rows wider than a warp, an odd head count),
     outputs pre-filled with NaN, and two calls bitwise equal; the
     edge-attention autograd Function (K1 forward, K2 backward) against
     autograd through the plain forward; then K1, K2 and the Function at
     head dims 6, 24, 64, 128, 256, 33 and 4096 and H*D = 1536, in float32
     and bfloat16 (both head layouts of the kernels);
  4. the predict path: ``cli.predict.predict_complex`` at the flagship
     width (2-layer GT, hidden 128, 4 heads, kNN 20; 14-chunk dilated
     decoder of 128 channels; seeded random weights) on three synthetic
     complexes, with the kernel launch and CSR build counts read around
     it, and the same model with the plain attention compared on logits;
  5. the training path: ``cli.train`` at the flagship width on a small
     on-disk dataset of the same three complexes (one epoch: three train
     steps, then val and test), with the launch and build counts read
     around it; then one train step and one eval step counted on their
     own, and one train step of the kernel path against one of the plain
     path from the same weights, batch and dropout seed, with the
     flagship's batch norm and with layer norm;
  5b. the training lifecycle at the flagship width, then with the DeepLab
     decoder on two complexes, under
     ``torch.use_deterministic_algorithms(True)`` (no op may refuse): ``cli.train`` for two
     epochs with a save after every step, the same preempted through the
     fault plan in the middle of epoch 2 (it must exit 0 with the
     preempted line) and resumed with ``--resume``, checked bitwise against
     the uninterrupted run (weights, AdamW moments, schedule, history,
     best/latest steps); the same without mid-epoch saves (asynchronous
     epoch saves); ``cli.test --ckpt_name`` against ``Trainer.evaluate`` of
     the restored best state and ``cli.predict --ckpt_name`` against
     ``predict_complex`` of the restored model, with exact launch counts
     around the resume, test and predict paths; the save, restore and
     epoch-overhead times and the bytes of a step;
  6. times with CUDA events (warm-up, median of >= 20 runs): each kernel
     (on a prebuilt CSR, as the main path runs it) and the CSR build at
     N = 64, 128, 192, 256 and 512 beside each kernel's bound, the plain
     versions at N = 256; predict per complex split into encode and
     decode (median of 5); the train step per complex (host clock around
     synchronized steps, median of 2) with its peak memory and its split into
     forward, backward and optimizer; one step of the largest complex
     under torch.profiler for its kernel count and device busy share;
  7. the model configurations beyond the flagship decoder, at the
     flagship encoder width with seeded weights: predict with the DeepLab
     decoder (resnet34, os 16, on the three complexes; os 8 on one), with
     tiled decoding of a 600x450 complex (buckets 768x512, six 256x256
     tiles) on the dilated and the DeepLab decoder, with the GCN encoder
     and with regional attention, each with exact launch counts, peak
     memory, encode / decode / wall times and its logits against the
     plain attention's; the tiled logits against direct decodes of the
     same tiles; DeepLab's factorized stem against its materialized one;
     one ``cli.train`` epoch with the DeepLab decoder (the three
     complexes), with tiled decoding (complexes of two tiles) and with 2
     attention heads (head dim 64), with exact launch counts, peak memory
     and a timed train step; predict with 2 heads;
  8a. decoder remat: a two-tile train step with ``--remat`` (each policy)
     and a DeepLab step with remat against the same step without it, under
     deterministic algorithms (loss 1e-5, gradients 1e-4); the two-tile
     step timed with and without remat; one ``cli.train`` epoch of the
     600x450 complex (six 256x256 tiles) with ``--tile_pair_map --remat``
     per policy, with peak memory and a timed step;
  8b. the reference-checkpoint importer: the golden fixture's reference
     state dict as a Lightning ``.ckpt`` through ``cli.import_checkpoint``
     and the ``cli.predict --ckpt_name`` loader against its reference
     logits (1e-4); a flagship-width reference ``.ckpt`` imported and
     predicted (kernel against plain path), ``cli.test`` on the ``.ckpt``
     itself, and one ``--fine_tune`` step from the imported directory;
  8c. ``cli.train --supervise`` at the flagship width with a hang injected
     (``training.hang``): one restart, a ``train_supervise/v1`` record that
     ``tools/check_cli_contract.py`` accepts, and the final state against
     an unsupervised run of the same command;
  9. serving: ``serving.InferenceEngine`` at the flagship width (seeded
     weights) with five warm-up keys, each captured once as a CUDA graph
     (128x128, 256x192, 64x256 at one slot, 256x192 at four, and the
     over-bucket 600x450 -> 768x512, six tiles): (K1, K2, CSR builds)
     measured around each capture, (4, 0, 2) for every key, K1 in a
     profiled replay, each key's replay on its served batch against the
     eager forward (bitwise, else 1e-6) and against the plain attention
     (phase 4's bar, rtol 1e-4 / atol 1e-4), served maps
     against ``predict_complex`` (1e-6; a slot of a coalesced four 1e-5;
     the over-bucket map 1e-4), no capture on the warm path; the served
     and eager latency per bucket, eight coalesced against eight
     sequential requests, a replay's host and device time, peak memory;
     then ``ServingServer`` on a free port (``/predict?trace=1``,
     ``/healthz``, ``/stats``, ``/metrics``) and a drain with a request
     in flight; then an engine with the GCN encoder and one with the
     DeepLab decoder, each with one key of 128x128 at one slot: (K1, K2,
     CSR builds) per capture (0, 0, 2) and (4, 0, 2), the replay against
     the eager forward (bitwise, else 1e-6) and the served map against
     ``predict_complex`` (1e-6);
 10. the split phase at the flagship width: a seeded synthetic library of
     16 chains of 40-250 residues (buckets 64-256) screened all-vs-all
     (120 pairs, ``--screen_batch 4``) through one CUDA graph per
     (chain bucket, slots) encode and per (bucket1, bucket2, slots) decode:
     (2, 0, 1) per encode capture, K1 in a profiled encode replay, exactly
     16 encodes, then a warm repeat with 16 cache hits, no encode and no
     capture; one pair per bucket pair encoded and decoded at one slot
     against the monolithic replay (bitwise, else 1e-6) and the plain
     attention (rtol / atol 1e-4), and decoded from the screen's
     embeddings (encoded in batches) against it within 1e-5, the bar of a
     coalesced slot; a manifest-backed screen preempted by its guard and
     resumed (no pair twice, scores within 1e-5 of the uninterrupted
     screen's); an index of the library, verified, and two queries (top_m
     8) whose scores are the screen's rows (1e-5); a 4-chain assembly with one
     chain twice (3 encodes) and its control score; the ``screen``,
     ``index`` (build, verify), ``query``, ``assemble``, ``calibrate`` (ECE
     lower after the fit) and ``predict --top_k --calibration`` CLIs, each
     last line through ``tools/check_cli_contract.py``; encode ms per chain
     and decode ms per pair per key (replay device time), the screen's
     pairs a second and its device time, and 16 of its pairs through
     ``engine.predict``.
 11. the split-phase routes and the serving fleet at the flagship width:
     (a) ``ServingServer`` in process (seeded weights): ``POST /screen``
     of 8 chains with its records against ``ScreenRunner.screen`` on the
     same engine and cache (bitwise, else 1e-6) and (2, 0, 1) per encode
     capture, ``POST /assembly`` of 4 chains with one twice (3 encodes;
     its K1 launches counted around it), an indexed ``/screen`` against
     phase 10's index against ``cli.query`` on it, an oversize screen
     (400) and a 1 ms deadline (504); (b) ``cli.serve --workers 2
     --warmup_buckets 128x128x1,256x192x1 --weights W`` (random weights
     from the seed): each engine worker warm with (4, 0, 2) per key read
     from its ``/stats``, ``/predict`` at 128x128 and 256x192 and
     ``/screen`` through the router against in-process replays on the
     same weights (bitwise, else 1e-6); (c) a worker SIGKILLed under 16
     concurrent ``/predict`` clients: no failed request, the worker
     restarted and warm, both workers answering; (d) ``POST
     /admin/rollover`` to a second weights file with its signature under
     load: no 5xx, old workers exit 0, maps equal to the new weights;
     then a rollover to a signature no replacement reaches aborts and the
     fleet keeps serving; the fleet's ``fleet/v1`` line through
     ``tools/check_cli_contract.py``; (e) start-to-warm seconds, routed
     and direct latency per bucket, latency before and during the swap,
     and the card's memory in use with 2 and 4 workers.
 12. the training dispatch loop at the flagship width: ``cli.train`` on 20
     train complexes in two buckets of 10 (runs of 8 and remainders of 2:
     six dispatches), 4 val and 4 test complexes, with
     ``--steps_per_dispatch 8 --eval_batches_per_dispatch 4
     --deterministic`` (its steps replay the step graphs), inline (run
     A), then with ``--device_prefetch
     --packed_cache_dir --profile_dir --profile_steps 2
     --viz_every_n_epochs 1`` and an in-process writer (run B): bitwise
     equal last/ states (weights, AdamW moments), per-step losses and
     histories (timings aside), the visited order equal to the loader's
     run-granular plan, exact (K1, K2, CSR builds) around each run, K1 and
     K2 at 4 x the steps of dispatches 1-2 (and of the warm-up steps of a
     key first captured there) in the exported Chrome trace with
     its ``step#n``, ``device_step`` and ``h2d`` ranges, run A's span log
     with one ``step`` per dispatch, the viz images, the packs reused by a
     third run that a ``data.place`` fault plan ends non-zero with
     ``PlacementError``; each run's epoch wall, data_wait, h2d and device
     shares, and the pinned bytes at the peak.
 13. the train and eval steps as CUDA graphs (one of each per bucket key,
     ``training/step_graphs.py``) at the flagship width: ``cli.train`` on
     phase 12's dataset under ``--deterministic`` at dropout 0.1, eager
     (``LoopConfig.step_graphs=False``) and graphed, then both again with
     the fifth batch of the epoch's first run of 8 poisoned with NaN:
     per-step losses and grad norms, histories, last/ states (weights,
     AdamW moments and count, batch-norm statistics) and test metrics
     bitwise equal, one skipped step each, exact launch counts (graphed:
     at the captures only); on a state of its own each capture's (K1, K2,
     CSR builds) and seconds, one profiled train replay (4, 4, 2) and
     eval replay (4, 0, 2) beside an eager step's kernel count, no
     synchronization while a full run of 8 is dispatched (one read of its
     metrics after), a full run's per-step wall graphed and eager, peak
     memory with every key captured; then DeepLab, the GCN encoder,
     regional attention and two-tile decoding with ``--remat``: a graphed
     run of 2 against two eager steps, bitwise.
 14. the featurization front end, on PDB files written in a temporary
     directory (helices of 180 and 140 residues cycling through the 20
     standard residues with side-chain atoms, whose side chains touch; a
     bound two-chain file; four small pairs) with ``DI_HHBLITS_*`` unset
     (the zero sequence profile): the port's ``geomfeats`` library built
     with the host's C++ compiler and required, each native geometry
     kernel against its numpy version (rtol 1e-4, atol 1e-3); featurize
     ms per chain; ``cli.predict --left_pdb --right_pdb --save_npz`` at the
     flagship width (4, 0, 2 launches) with a finite 180x140 map, bitwise
     equal to ``cli.predict --input_npz`` on the saved npz; the wall from
     PDB files to map; a JSON ``{"left_pdb", "right_pdb"}`` POST to an
     engine's ``ServingServer`` against ``predict_complex`` (1e-6), (4, 0,
     2) at its capture; ``cli.build_dataset`` over the four pairs,
     ``cli.analyze stats`` and ``lengths``, and a ``BucketedLoader`` pass
     over the tree. At most 60 s.
A phase that fails prints ``chip_smoke: phase <n> failed: <reason>`` on
stdout and the run exits 1; a watchdog ends a run still going after
``SCRIPT_LIMIT_S`` the same way. The line before the last is the card's
name and power limit; before it, a ``{"kernels": [...]}`` JSON line,
before that phase 14's ``{"frontend": {...}}`` summary, before that
phase 12's ``{"dispatch":
{...}}`` summary, before that phase 13's ``{"step_graphs": {...}}`` one,
before that phase 11's ``{"fleet": {...}}`` summary,
before that phase 10's ``{"screening": {...}}`` one,
and before that phase 9's ``{"serving": {...}}`` one. The last line is the device record
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 1 and
prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import http.client
import io
import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback

import numpy as np
import torch

from deepinteract_tpu_torch import constants
from deepinteract_tpu_torch.cli import predict as predict_cli
from deepinteract_tpu_torch.cli import test as test_cli
from deepinteract_tpu_torch.cli import train as train_cli
from deepinteract_tpu_torch.cli.args import build_parser, model_config_from_args
from deepinteract_tpu_torch.cli.predict import load_model, predict_complex
from deepinteract_tpu_torch.data import features
from deepinteract_tpu_torch.data.datasets import DIPSDataset
from deepinteract_tpu_torch.data.graph import pad_graph, pick_bucket, stack_complexes
from deepinteract_tpu_torch.data.io import load_complex_npz, save_complex_npz, to_paired_complex
from deepinteract_tpu_torch.data.loader import BucketedLoader
from deepinteract_tpu_torch.data.synthetic import (random_backbone, random_raw_complex,
                                                   random_residue_feats,
                                                   write_tiny_npz_dataset)
from deepinteract_tpu_torch.models.interaction import interaction_tensor
from deepinteract_tpu_torch.models.layers import DropoutKey, dropout_rng
from deepinteract_tpu_torch.models.model import ModelConfig
from deepinteract_tpu_torch.models.stem import PairFactors
from deepinteract_tpu_torch.models.policy import set_backend_precision
from deepinteract_tpu_torch.ops import attention as plain
from deepinteract_tpu_torch.ops import cuda_attention
from deepinteract_tpu_torch.robustness import artifacts, faults
from deepinteract_tpu_torch.training.checkpoint import PAYLOAD, CheckpointConfig, Checkpointer
from deepinteract_tpu_torch.training.loop import Trainer, host_snapshot, read_sidecar
from deepinteract_tpu_torch.training.objective import contact_loss
from deepinteract_tpu_torch.training import step_graphs
from deepinteract_tpu_torch.training.steps import (create_train_state, eval_step,
                                                   multi_eval_step, multi_train_step,
                                                   train_step)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # H100 SXM data sheet: float32 outside the tensor cores
COMPLEXES = ((100, 80), (200, 180), (60, 250))  # -> buckets 128/128, 256/192, 64/256
LAUNCHES_PER_ENCODE_PAIR = 4  # 2 GT layers x 2 siamese encodes
BUILDS_PER_ENCODE_PAIR = 2  # one in-edge CSR per encode
# Counted around the main paths: K1 launches, K2 launches, CSR builds.
COUNTERS = (cuda_attention.edge_attention_forward, cuda_attention.edge_attention_backward)
TIMED_N = {64: 50, 128: 100, 192: 180, 256: 200, 512: 450, 768: 600}  # bucket -> real nodes


T0 = time.perf_counter()


def loss_and_grads(model, batch, seed: int) -> torch.Tensor:
    """Train-mode forward of ``batch`` with the dropout key of step 0 of a
    run seeded ``seed``, the contact loss, and its backward into ``.grad``
    (zeroed first). Returns the loss, detached."""
    device = batch.contact_map.device
    model.train()
    model.zero_grad(set_to_none=True)
    key = DropoutKey(torch.tensor(seed, device=device), torch.tensor(0, device=device))
    with dropout_rng(model, key):
        loss = contact_loss(model(batch.graph1, batch.graph2), batch.contact_map,
                            batch.pair_mask)
        loss.backward()
    return loss.detach()


def log(msg: str) -> None:
    if msg.startswith("== "):  # a phase header: with the seconds since the start
        msg = f"{msg} [t = {time.perf_counter() - T0:.1f} s]"
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


# The whole run is held to this limit, just inside the 1200 s that a smoke
# run is given: past it the run stops and names the phase it was in,
# rather than being cut without a word.
SCRIPT_LIMIT_S = 1180.0
_current_phase = ["start"]


@contextlib.contextmanager
def phase(n: str):
    """Run one phase of ``main``. Its failure prints ``chip_smoke: phase
    <n> failed: <exception>`` on stdout (a traceback on stderr for an
    exception other than a failed check) and exits 1."""
    _current_phase[0] = n
    try:
        yield
    except KeyboardInterrupt:
        raise
    except BaseException as exc:  # noqa: BLE001 - reported, then the run exits 1
        if isinstance(exc, SystemExit):
            what = str(exc.code)
        else:
            what = f"{type(exc).__name__}: {exc}"
            traceback.print_exc()
        print(f"chip_smoke: phase {n} failed: {what}", flush=True)
        raise SystemExit(1) from exc


def _child_pids(pid: int) -> list:
    """Every descendant of ``pid``, read from /proc."""
    out = []
    for task in os.listdir(f"/proc/{pid}/task"):
        try:
            with open(f"/proc/{pid}/task/{task}/children") as f:
                kids = [int(k) for k in f.read().split()]
        except OSError:
            continue
        for kid in kids:
            out += [kid] + _child_pids(kid)
    return out


def _overrun() -> None:
    """The watchdog's end of a run past ``SCRIPT_LIMIT_S``: name the phase,
    stop the processes this run started, exit 1."""
    print(f"chip_smoke: phase {_current_phase[0]} failed: the run passed its "
          f"{SCRIPT_LIMIT_S:.0f} s limit", flush=True)
    for pid in _child_pids(os.getpid()):
        with contextlib.suppress(OSError):
            os.kill(pid, signal.SIGKILL)
    os._exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, runs: int = 20, inner: int = 1, warmup: int = 3) -> float:
    """Median over ``runs`` of CUDA-event time per call, each run timing
    ``inner`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def device_ms(fn, runs: int = 20, inner: int = 20, warmup: int = 3) -> tuple:
    """(device ms, host ms) per call of ``fn``. Device: median over
    ``runs`` of CUDA-event time per call over ``inner`` back-to-back calls,
    enqueued behind a spin of the card that outlasts the host's enqueue of
    them, so they run back to back and the host's cost per call (Python,
    argument checks, allocation, the ctypes call) is not in it. Host: the
    median wall time per call to enqueue them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    device, host = [], []
    spin = 0
    for _ in range(runs):
        if spin:
            torch.cuda._sleep(spin)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        enqueue_s = time.perf_counter() - t0
        end.record()
        end.synchronize()
        host.append(enqueue_s * 1e3 / inner)
        device.append(start.elapsed_time(end) / inner)
        spin = int(3 * enqueue_s * 2e9)  # cycles: three times the enqueue at 2 GHz
    return statistics.median(device[1:]), statistics.median(host)


def reset_launches() -> None:
    for kernel in COUNTERS:
        kernel.launches = 0
    cuda_attention.in_edge_csr.builds = 0


def launches() -> tuple:
    """(K1 launches, K2 launches, CSR builds) since the last reset."""
    return (*(kernel.launches for kernel in COUNTERS), cuda_attention.in_edge_csr.builds)


# ---------------------------------------------------------------------------
# Phase 3: kernel parity
# ---------------------------------------------------------------------------


def attention_case(rng, batch, n_real, n_pad, knn, heads, head_dim, dtype, orphan=None,
                   hub=None, device="cuda"):
    """Attention inputs on the card over real kNN graphs with a padded tail;
    ``orphan`` names a node of graph 0 left without in-edges; ``hub =
    (node, sources)`` sends every edge of graph 0's first ``sources``
    nodes to ``node``."""
    nbrs, masks = [], []
    for _ in range(batch):
        raw = features.featurize_chain(random_backbone(n_real, rng),
                                       random_residue_feats(n_real, rng), knn=knn, rng=rng)
        g = pad_graph(raw, n_pad)
        nbrs.append(g.nbr_idx)
        masks.append(g.edge_mask())
    nbr = torch.stack(nbrs).to(torch.int32)
    if orphan is not None:
        nbr[0][nbr[0] == orphan] = orphan + 1
    if hub is not None:
        nbr[0, :hub[1]] = hub[0]
    dev = torch.device(device)
    shape = (batch, n_pad, heads, head_dim)
    qkv = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
           for _ in range(3)]
    pe = torch.from_numpy(rng.standard_normal((batch, n_pad, knn, heads, head_dim))
                          .astype(np.float32)).to(dev, dtype)
    return (*qkv, pe, nbr.to(dev).contiguous(), torch.stack(masks).float().to(dev).contiguous())


def to_bf16(args):
    return tuple(t.to(torch.bfloat16) if t.is_floating_point() and t.dim() >= 4 else t
                 for t in args)


def check_csr(name, nbr):
    """The in-edge CSR built on the card against a stable argsort of nbr on
    the CPU."""
    in_ptr, in_eid = cuda_attention.in_edge_csr(nbr)
    flat = nbr.cpu().numpy().reshape(nbr.shape[0], -1)
    counts = np.stack([np.bincount(row, minlength=nbr.shape[1]) for row in flat])
    ref_ptr = np.concatenate([np.zeros((len(flat), 1), np.int64), np.cumsum(counts, 1)], 1)
    check(np.array_equal(in_ptr.cpu().numpy(), ref_ptr), f"{name}: CSR in_ptr differs")
    check(np.array_equal(in_eid.cpu().numpy(), np.argsort(flat, axis=1, kind="stable")),
          f"{name}: CSR in_eid differs from a stable argsort")
    log(f"  CSR {name}: equals the CPU stable argsort (max in-degree "
        f"{int(counts.max())})")
    return in_ptr, in_eid


def nan_buffers(device, *like):
    return tuple(torch.full(shape, float("nan"), device=device, dtype=dtype)
                 for shape, dtype in like)


def check_attention(name, args, tol, orphan=None) -> dict:
    """K1 against its plain version on a CSR built on the card, into
    NaN-filled buffers, twice (bitwise equal)."""
    q = args[0]
    b, n, h, d = q.shape
    kk = args[4].shape[-1]
    in_edges = check_csr(name, args[4])
    like = (((b, n, h, d), torch.float32), ((b, n, kk, h, d), q.dtype),
            ((b, n, h * d), torch.float32))
    got = cuda_attention.edge_attention_forward(*args, out=nan_buffers(q.device, *like),
                                                in_edges=in_edges)
    again = cuda_attention.edge_attention_forward(*args, out=nan_buffers(q.device, *like),
                                                  in_edges=in_edges)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{name}: two K1 calls differ")
    ref = plain.edge_attention_forward(*args)
    errs = {}
    for label, g, r in zip(("h", "e_out", "z"), got, ref):
        check(not torch.isnan(g).any(), f"{name}: {label} has unwritten (NaN) elements")
        g, r = g.float(), r.float()
        errs[label] = (g - r).abs().max().item()
        check(torch.allclose(g, r, rtol=tol, atol=tol),
              f"{name}: {label} differs from the plain version by {errs[label]:.3g} (tol {tol})")
    if orphan is not None:
        check(bool((got[0][0, orphan] == 0).all()), f"{name}: node without in-edges has h != 0")
    log(f"  K1 {name}: max |kernel - plain| h {errs['h']:.3g}  e_out {errs['e_out']:.3g}  "
        f"z {errs['z']:.3g}  (tol {tol}); two calls bitwise equal")
    return errs


def attention_bound(args, outputs):
    """(bound ms, what bounds it) for the fused forward on these inputs:
    each input read once and each output written once over the memory
    rate, against its float32 arithmetic over the float32 rate. Per (edge,
    lane): the score's two multiplies, the two-sided clip, the gate by pe,
    the mask, the head-sum add, w*v and its sum (9); per (edge, head): the
    clip, exp, mask and z sum (5); per node lane: the division."""
    nbytes = sum(t.numel() * t.element_size() for t in (*args, *outputs))
    b, n, h, d = args[0].shape
    edges = args[4].numel()
    ops = edges * h * d * 9 + edges * h * 5 + b * n * h * d
    return _bound("K1", nbytes, ops)


def _bound(name, nbytes, ops):
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    log(f"  {name} bound: {nbytes} B -> {bytes_ms:.5f} ms; {ops} float32 ops -> {ops_ms:.5f} ms")
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def backward_case(rng, args, with_de=True):
    """K2's inputs for the forward inputs ``args``: the forward's residuals
    h and z (plain version), a float32 cotangent dh and, ``with_de``, an
    e_out cotangent de in the input dtype."""
    h, _, z = plain.edge_attention_forward(*args)
    dh = torch.from_numpy(rng.standard_normal(tuple(h.shape)).astype(np.float32)).to(h.device)
    de = None
    if with_de:
        de = torch.from_numpy(rng.standard_normal(tuple(args[3].shape)).astype(np.float32))
        de = de.to(h.device, args[0].dtype)
    return (*args, h, z, dh, de)


def check_backward(name, bargs, tol, orphan=None) -> float:
    """K2 against its plain version, into NaN-filled buffers, twice
    (bitwise equal)."""
    q, proj_e, edge_mask = bargs[0], bargs[3], bargs[5]
    like = [(t.shape, q.dtype) for t in (q, q, q, proj_e)]
    in_edges = cuda_attention.in_edge_csr(bargs[4])
    got = cuda_attention.edge_attention_backward(*bargs, out=nan_buffers(q.device, *like),
                                                 in_edges=in_edges)
    again = cuda_attention.edge_attention_backward(*bargs, out=nan_buffers(q.device, *like),
                                                   in_edges=in_edges)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{name}: two K2 calls differ")
    ref = plain.edge_attention_backward(*bargs)
    errs = {}
    for label, g, r in zip(("dq", "dk", "dv", "dpe"), got, ref):
        check(not torch.isnan(g).any(), f"{name}: {label} has unwritten (NaN) elements")
        check(g.dtype == q.dtype, f"{name}: {label} is {g.dtype}, not {q.dtype}")
        g, r = g.float(), r.float()
        errs[label] = (g - r).abs().max().item()
        check(torch.allclose(g, r, rtol=tol, atol=tol),
              f"{name}: {label} differs from the plain version by {errs[label]:.3g} (tol {tol})")
    check(bool((got[3][edge_mask == 0] == 0).all()), f"{name}: masked edges have dpe != 0")
    if orphan is not None:
        check(bool((got[0][0, orphan] == 0).all()), f"{name}: node without in-edges has dq != 0")
    log(f"  K2 {name}: max |kernel - plain| " + "  ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f"  (tol {tol}); two calls bitwise equal")
    return max(errs.values())


def backward_bound(bargs, outputs):
    """(bound ms, what bounds it) for the fused backward on these inputs
    (de skipped when None). Per (edge, lane): the score (2 multiplies, 2
    clip compares), the gate by pe, its head-sum add, dnum * v and its
    head-sum add, de * mask and its add to ds, dpe = ds * c, ds * pe, the
    clip select, the 1/sqrt(D) scale, da * k, da * q, w * dnum and the three
    sums into dq, dk, dv (20); per (edge, head): the clip, exp, mask, the
    dZ add, dw * w and the clip select (7); per node lane: z + eps, its
    reciprocal, dh times it, h * dnum, its head-sum add and the negation (6)."""
    nbytes = sum(t.numel() * t.element_size() for t in (*bargs, *outputs) if t is not None)
    b, n, h, d = bargs[0].shape
    edges = bargs[4].numel()
    ops = edges * h * d * 20 + edges * h * 7 + b * n * h * d * 6
    return _bound("K2", nbytes, ops)


def check_autograd(name, args, tol, with_de=True) -> float:
    """Grads of (h, e_out) -> a random scalar through EdgeAttention against
    autograd through the plain forward. The plain side runs on float32
    copies of the inputs: its gather of q would otherwise sum bfloat16
    gradients in bfloat16, while K2 sums in float32 and rounds once."""
    gen = torch.Generator(device=args[0].device).manual_seed(7)
    grads = []
    for forward in ("function", "plain"):
        if forward == "function":
            leaves = [t.detach().clone().requires_grad_(True) for t in args[:4]]
            h, e = cuda_attention.EdgeAttention.apply(*leaves, *args[4:])
        else:
            leaves = [t.detach().float().requires_grad_(True) for t in args[:4]]
            h, e, _ = plain.edge_attention_forward(*leaves, *args[4:])
        gen.manual_seed(7)
        gh = torch.randn(h.shape, generator=gen, device=h.device)
        loss = (h * gh).sum()
        if with_de:
            loss = loss + (e.float() * torch.randn(e.shape, generator=gen, device=h.device)).sum()
        grads.append(torch.autograd.grad(loss, leaves))
    err = 0.0
    for label, g, r in zip(("q", "k", "v", "proj_e"), *grads):
        g, r = g.float(), r.float()
        err = max(err, (g - r).abs().max().item())
        check(torch.allclose(g, r, rtol=tol, atol=tol),
              f"autograd {name}: d{label} differs from autograd of the plain forward by "
              f"{(g - r).abs().max().item():.3g} (tol {tol})")
    log(f"  EdgeAttention {name}: max |Function - autograd(plain)| {err:.3g} (tol {tol})")
    return err


def build_kernels() -> None:
    log("== phase 2: build")
    for kname, built in cuda_attention.build().items():
        log(f"  {kname}: {built['seconds']:.2f} s -> {built['path']}")
        for line in built["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"    {line.strip()}")


# (heads, head dim) beyond the flagship's D=32, each in float32 and bfloat16:
# the head layouts of csrc/edge_attention_common.cuh. Warp heads padded to a
# power of two (D = 6, 24, 96), one head a warp (64, 128, bf16 256); block
# heads (f32 256, 33, 4096, where a head outgrows 32 vector lanes).
HEAD_DIM_CASES = ((4, 6), (4, 24), (2, 64), (1, 128), (1, 256), (16, 96), (2, 33), (1, 4096))


def head_dim_parity(rng, device="cuda") -> dict:
    """K1, K2 and the autograd Function against their plain versions at
    every (H, D) of HEAD_DIM_CASES, float32 (1e-5 / 1e-4) and bfloat16
    (3e-2), the first with an orphan node. Returns the largest errors
    {"k1": .., "k2": .., "function": ..} per dtype."""
    out = {"float32": dict.fromkeys(("k1", "k2", "function"), 0.0)}
    out["bfloat16"] = dict(out["float32"])
    for i, (heads, head_dim) in enumerate(HEAD_DIM_CASES):
        orphan = 3 if i == 0 else None
        batch = 1 if heads * head_dim > 1024 else 2
        args = attention_case(rng, batch, 50, 64, 20, heads, head_dim, torch.float32,
                              orphan=orphan, device=device)
        for dtype, case, tols in (("float32", args, (1e-5, 1e-4)),
                                  ("bfloat16", to_bf16(args), (3e-2, 3e-2))):
            name = f"H={heads} D={head_dim} {dtype} (B={batch} N=64/50)"
            errs = out[dtype]
            errs["k1"] = max(errs["k1"], *check_attention(name, case, tols[0],
                                                          orphan=orphan).values())
            errs["k2"] = max(errs["k2"], check_backward(name, backward_case(rng, case), tols[1],
                                                        orphan=orphan))
            errs["function"] = max(errs["function"], check_autograd(name, case, tols[1]))
    log(f"  head dims {[d for _, d in HEAD_DIM_CASES]}: largest errors {out}")
    return out


def kernel_parity(rng, device="cuda"):
    """Phase 3 (on CPU tensors with ``device="cpu"``, a rehearsal of the
    wrappers' plain versions). Returns (flagship inputs, their K2 inputs, K1's errors at
    the flagship, K2's largest error there, (K1's, K2's) largest error at N=768, the
    head-dim cases' errors)."""
    log("== phase 3: kernel parity on the card")
    f32 = torch.float32
    flagship = attention_case(rng, 1, 200, 256, 20, 4, 32, f32, device=device)
    hub = attention_case(rng, 1, 200, 256, 20, 4, 32, f32, hub=(5, 64), device=device)
    n512 = attention_case(rng, 1, 450, 512, 20, 4, 32, f32, device=device)
    n768 = attention_case(rng, 1, 600, 768, 20, 4, 32, f32, device=device)
    orphan = attention_case(rng, 2, 50, 64, 20, 4, 8, f32, orphan=3, device=device)
    # H*D = 1024: rows of 8 warp-wide chunks (f32) or 4 at 8 elements per
    # lane (bf16). H*D = 48 (3 heads): one element per lane, a part-filled
    # second chunk.
    wide = attention_case(rng, 1, 100, 128, 20, 32, 32, f32, device=device)
    odd = attention_case(rng, 2, 50, 64, 20, 3, 16, f32, device=device)
    cases = (("flagship f32 (B=1 N=256/200 K=20 H=4 D=32)", flagship, None),
             ("flagship bf16", to_bf16(flagship), None),
             ("hub: node 5 takes every edge of nodes 0-63 (B=1 N=256/200)", hub, None),
             ("N=512 bucket (B=1 N=512/450)", n512, None),
             ("N=768 bucket, a tiled chain's (B=1 N=768/600)", n768, None),
             ("B=2 N=64/50 D=8 with an orphan node", orphan, 3),
             ("H*D=1024 (B=1 N=128/100 H=32 D=32)", wide, None),
             ("H*D=1024 bf16", to_bf16(wide), None),
             ("3 heads (B=2 N=64/50 H=3 D=16)", odd, None))
    bf16 = lambda args: args[0].dtype == torch.bfloat16  # noqa: E731
    fwd_errs = [check_attention(name, args, 3e-2 if bf16(args) else 1e-5, orphan=orph)
                for name, args, orph in cases]
    flagship_bwd = backward_case(rng, flagship)
    bwd_err = check_backward("flagship f32", flagship_bwd, 1e-4)
    check_backward("flagship f32, de=None", backward_case(rng, flagship, with_de=False), 1e-4)
    bwd_errs = [check_backward(name, backward_case(rng, args), 3e-2 if bf16(args) else 1e-4,
                               orphan=orph) for name, args, orph in cases[1:]]
    at768 = [name for name, _, _ in cases].index("N=768 bucket, a tiled chain's (B=1 N=768/600)")
    n768_errs = (max(fwd_errs[at768].values()), bwd_errs[at768 - 1])
    check_autograd("flagship f32", flagship, 1e-4)
    check_autograd("flagship f32, e_out unused", flagship, 1e-4, with_de=False)
    check_autograd("flagship bf16", to_bf16(flagship), 3e-2)
    head_dims = head_dim_parity(rng, device)
    return flagship, flagship_bwd, fwd_errs[0], bwd_err, n768_errs, head_dims


def time_kernels(rng, flagship, flagship_bwd) -> dict:
    """K1, K2 (with de) and the CSR build at B=1, K=20, H*D=128 f32 for
    each bucket N of TIMED_N (N=256: the flagship case), each kernel on a
    prebuilt CSR as the main path runs it, beside its bound; the plain
    versions at N=256; K1 and K2 at N=256 for each (H, D) of
    HEAD_DIM_CASES, beside their bounds."""
    by_n = {}
    with torch.inference_mode():
        for n, real in TIMED_N.items():
            args = flagship if n == 256 else attention_case(rng, 1, real, n, 20, 4, 32,
                                                            torch.float32)
            bargs = flagship_bwd if n == 256 else backward_case(rng, args)
            csr = cuda_attention.in_edge_csr(args[4])
            out = cuda_attention.edge_attention_forward(*args, in_edges=csr)
            grads = cuda_attention.edge_attention_backward(*bargs, in_edges=csr)
            k1_ms, k1_host = device_ms(
                lambda: cuda_attention.edge_attention_forward(*args, in_edges=csr))
            k2_ms, k2_host = device_ms(
                lambda: cuda_attention.edge_attention_backward(*bargs, in_edges=csr))
            csr_ms, _ = device_ms(lambda: cuda_attention.in_edge_csr(args[4]))
            k1_bound, k1_by = attention_bound(args, out)
            k2_bound, k2_by = backward_bound(bargs, grads)
            by_n[n] = {"k1_ms": k1_ms, "k1_host_ms": k1_host, "k1_bound_ms": k1_bound,
                       "k1_bound_by": k1_by, "k2_ms": k2_ms, "k2_host_ms": k2_host,
                       "k2_bound_ms": k2_bound, "k2_bound_by": k2_by, "csr_ms": csr_ms}
            log(f"  N={n} ({real} real, B=1 K=20 H*D=128 f32): K1 {k1_ms:.5f} ms (bound "
                f"{k1_bound:.5f}, {k1_ms / k1_bound:.1f}x; host {k1_host:.4f} ms/call), K2 "
                f"{k2_ms:.5f} ms (bound {k2_bound:.5f}, {k2_ms / k2_bound:.1f}x; host "
                f"{k2_host:.4f} ms/call), CSR build {csr_ms:.5f} ms")
        k1_plain, _ = device_ms(lambda: plain.edge_attention_forward(*flagship), inner=5)
        k2_plain, _ = device_ms(lambda: plain.edge_attention_backward(*flagship_bwd), inner=5)
    log(f"  N=256 plain versions: K1 {k1_plain:.4f} ms, K2 {k2_plain:.4f} ms")
    by_head_dim = {}
    with torch.inference_mode():
        for heads, head_dim in HEAD_DIM_CASES:
            args = attention_case(rng, 1, 200, 256, 20, heads, head_dim, torch.float32)
            bargs = backward_case(rng, args)
            csr = cuda_attention.in_edge_csr(args[4])
            out = cuda_attention.edge_attention_forward(*args, in_edges=csr)
            grads = cuda_attention.edge_attention_backward(*bargs, in_edges=csr)
            k1_ms, _ = device_ms(lambda: cuda_attention.edge_attention_forward(*args,
                                                                               in_edges=csr))
            k2_ms, _ = device_ms(lambda: cuda_attention.edge_attention_backward(*bargs,
                                                                                in_edges=csr))
            k1_bound, _ = attention_bound(args, out)
            k2_bound, _ = backward_bound(bargs, grads)
            by_head_dim[f"H={heads} D={head_dim}"] = {
                "k1_ms": k1_ms, "k1_bound_ms": k1_bound, "k2_ms": k2_ms, "k2_bound_ms": k2_bound}
            log(f"  H={heads} D={head_dim} (B=1 N=256/200 K=20 f32): K1 {k1_ms:.5f} ms (bound "
                f"{k1_bound:.5f}), K2 {k2_ms:.5f} ms (bound {k2_bound:.5f})")
    return {"by_n": by_n, "k1_plain_ms": k1_plain, "k2_plain_ms": k2_plain,
            "by_head_dim": by_head_dim}


# ---------------------------------------------------------------------------
# Phase 4: predict path
# ---------------------------------------------------------------------------


def run_predict_path(model, plain_model, raws, device):
    per_complex = []
    results = []
    reset_launches()
    for raw in raws:
        before = launches()
        results.append(predict_complex(raw, model, device))
        per_complex.append(tuple(a - b for a, b in zip(launches(), before)))
    total = launches()
    expected = (LAUNCHES_PER_ENCODE_PAIR, 0, BUILDS_PER_ENCODE_PAIR)
    for (n1, n2), res, count in zip(COMPLEXES, results, per_complex):
        probs = res["contact_prob_map"]
        check(count == expected, f"predict {n1}x{n2}: (K1, K2 launches, CSR builds) {count}, "
              f"expected {expected}")
        check(probs.shape == (n1, n2), f"complex {n1}x{n2}: probs shape {probs.shape}")
        check(bool(np.isfinite(probs).all()) and probs.min() >= 0 and probs.max() <= 1,
              f"complex {n1}x{n2}: probabilities not finite in [0, 1]")
    diffs = []
    for (n1, n2), raw, res in zip(COMPLEXES, raws, results):
        ref = predict_complex(raw, plain_model, device)["logits"]
        diff = float(np.abs(ref - res["logits"]).max())
        diffs.append(diff)
        check(np.allclose(res["logits"], ref, rtol=1e-4, atol=1e-4),
              f"complex {n1}x{n2}: kernel vs plain logits differ by {diff:.3g}")
        log(f"  {n1}x{n2}: K1 launches {LAUNCHES_PER_ENCODE_PAIR}, CSR builds "
            f"{BUILDS_PER_ENCODE_PAIR}, probs in "
            f"[{res['contact_prob_map'].min():.4f}, {res['contact_prob_map'].max():.4f}], "
            f"max |logits kernel - plain| {diff:.3g}")
    check(launches() == total, "the plain-attention model launched a kernel or built a CSR")
    return total, diffs


def time_predict(model, raw, device, runs: int = 20) -> dict:
    """Encode (both chains) and decode ms from CUDA events, and the whole
    predict_complex call (host to host) from the wall clock; medians of
    ``runs``."""
    cx = stack_complexes([to_paired_complex(raw)]).to(device)
    model.eval()
    with torch.inference_mode():
        f1, _ = model.encode(cx.graph1)
        f2, _ = model.encode(cx.graph2)

        def encode():
            model.encode(cx.graph1)
            model.encode(cx.graph2)

        def decode():
            model.decode(f1, f2, cx.graph1.node_mask, cx.graph2.node_mask)

        enc = time_ms(encode, runs=runs)
        dec = time_ms(decode, runs=runs)
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        predict_complex(raw, model, device)
        walls.append((time.perf_counter() - t0) * 1e3)
    return {"encode_ms": enc, "decode_ms": dec, "predict_wall_ms": statistics.median(walls)}


# ---------------------------------------------------------------------------
# Phase 5: training path
# ---------------------------------------------------------------------------


def run_train_path(root, seed):
    """``cli.train`` for one epoch at the flagship width; returns the launch
    and build counts around it and the number of train steps."""
    args = train_cli.parse_args(["--dips_root", root, "--num_epochs", "1", "--seed", str(seed),
                                 "--log_every", "1", "--ckpt_dir", os.path.join(root, "ckpt")])
    reset_launches()
    history, test = train_cli.run(args)
    counts = launches()
    (epoch,) = history
    steps = int(epoch["train_steps"])
    check(steps == len(COMPLEXES), f"train: {steps} steps, expected {len(COMPLEXES)}")
    _expect_graphed("train", counts, _split(root, "train"),
                    _split(root, "val") + _split(root, "test"))
    check(epoch["train_skipped_steps"] == 0, "train: the non-finite guard skipped a step")
    for key, value in (("train_loss", epoch["train_loss"]), ("val_ce", epoch["val_ce"]),
                       ("test_ce", test["test_ce"])):
        check(math.isfinite(value), f"train: {key} = {value}")
    log(f"  cli.train 1 epoch: {steps} train steps, launches K1 {counts[0]} K2 {counts[1]}, "
        f"CSR builds {counts[2]}, "
        f"train_loss {epoch['train_loss']:.4f}, val_ce {epoch['val_ce']:.4f}, "
        f"test_ce {test['test_ce']:.4f}, med_test_auroc {test['med_test_auroc']:.4f}")
    return counts, steps


def check_step_launches(state, batch):
    reset_launches()
    m = train_step(state, batch, guard=True)
    torch.cuda.synchronize()
    expected = (LAUNCHES_PER_ENCODE_PAIR, LAUNCHES_PER_ENCODE_PAIR, BUILDS_PER_ENCODE_PAIR)
    check(launches() == expected,
          f"train step: (K1, K2 launches, CSR builds) {launches()}, expected {expected}")
    check(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]) and not m["bad_step"],
          f"train step: metrics {m}")
    reset_launches()
    out = eval_step(state, batch)
    expected = (LAUNCHES_PER_ENCODE_PAIR, 0, BUILDS_PER_ENCODE_PAIR)
    check(launches() == expected,
          f"eval step: (K1, K2 launches, CSR builds) {launches()}, expected {expected}")
    check(bool(torch.isfinite(out["loss"])), "eval step: loss not finite")
    log(f"  one train step: K1 4, K2 4 launches, 2 CSR builds, loss {m['loss']:.4f}, "
        f"grad_norm {m['grad_norm']:.4f}; one eval step: K1 4, K2 0, 2 CSR builds")


def compare_train_step(label, model, plain_model, batch, seed, spread_seeds=()):
    """Loss and every gradient of one train step, kernel path against plain
    path, from the same weights, batch and dropout seed: loss within 1e-5,
    every gradient within 1e-4 (rtol and atol). With ``spread_seeds``,
    each gradient tensor's atol adds four times its spread on the plain
    path when the weights move by 1e-7 relative (float32 rounding), one
    move per seed: the train-mode batch norm (count n_valid * C) makes the
    first GT layer's gradients ill-conditioned, and two float32 summation
    orders cannot agree to 1e-4 there. Returns (|loss diff|, max |grad
    diff|, max spread)."""
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    batch = batch.to(next(model.parameters()).device)

    def step(m, state):
        m.load_state_dict(state)
        loss = loss_and_grads(m, batch, seed)
        return loss.item(), {n: p.grad.detach().clone() for n, p in m.named_parameters()}

    loss_k, grads_k = step(model, weights)
    loss_p, grads_p = step(plain_model, weights)
    model.load_state_dict(weights)  # the step updated the batch statistics
    spread = dict.fromkeys(grads_p, 0.0)
    params = dict(model.named_parameters())
    for s in spread_seeds:
        gen = torch.Generator().manual_seed(s)
        moved = {k: (v * (1 + 1e-7 * torch.randn(v.shape, generator=gen).to(v.device))
                     if k in params else v) for k, v in weights.items()}
        for name, g in step(plain_model, moved)[1].items():
            spread[name] = max(spread[name], (g - grads_p[name]).abs().max().item())
    check(abs(loss_k - loss_p) <= 1e-5,
          f"{label}: train step loss kernel {loss_k} vs plain {loss_p}")
    worst = (0.0, "")
    for name, g in grads_k.items():
        r = grads_p[name]
        err = (g - r).abs().max().item()
        worst = max(worst, (err, name))
        check(torch.allclose(g, r, rtol=1e-4, atol=1e-4 + 4 * spread[name]),
              f"{label}: grad {name} differs by {err:.3g} between kernel and plain path "
              f"(atol 1e-4 + 4 x spread {spread[name]:.3g})")
    log(f"  {label}: train step kernel vs plain |loss diff| {abs(loss_k - loss_p):.3g} "
        f"(tol 1e-5), max |grad diff| {worst[0]:.3g} at {worst[1]} ({len(grads_k)} tensors; "
        f"tol 1e-4" + (f" + 4 x spread, max spread {max(spread.values()):.3g})"
                       if spread_seeds else ")"))
    return abs(loss_k - loss_p), worst[0], max(spread.values())


def time_train_step(state, batch, runs: int = 10, warmup: int = 2, split: bool = True) -> dict:
    """Train step ms (forward + backward + optimizer, host clock around
    synchronized steps, median of ``runs`` after ``warmup``), its peak
    device memory, and (``split``) the same step split at synchronize
    points into the train-mode forward with the loss, the backward, and
    the optimizer update (medians)."""
    for _ in range(warmup):
        train_step(state, batch, guard=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        train_step(state, batch, guard=True)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    model = state.model
    phases = {"forward_ms": [], "backward_ms": [], "optimizer_ms": []}
    for _ in range(runs if split else 0):
        t0 = time.perf_counter()
        model.train()
        state.optimizer.zero_grad()
        with dropout_rng(model, DropoutKey(state.seed_t, state.step_t)):
            loss = contact_loss(model(batch.graph1, batch.graph2), batch.contact_map,
                                batch.pair_mask)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        state.optimizer.apply_update()
        state.step_t.add_(1)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for key, dt in zip(phases, (t1 - t0, t2 - t1, t3 - t2)):
            phases[key].append(dt * 1e3)
    return {"train_step_ms": statistics.median(walls), "max_memory_allocated_gb": peak,
            **{k: statistics.median(v) for k, v in phases.items() if v}}


def profile_train_step(state, batch) -> dict:
    """One train step under ``torch.profiler``: the wall time (inflated by
    the profiler), the number of device kernels and their summed device
    time. Kernels run on one stream, so summed time over wall is the
    device's busy share; an empty device trace reports None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    train_step(state, batch, guard=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(state, batch, guard=True)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 if kernels else None
    return {"wall_ms": wall_ms, "kernels": len(kernels), "device_busy_ms": busy_ms}


# ---------------------------------------------------------------------------
# Phase 5b: the training lifecycle
# ---------------------------------------------------------------------------

LIFECYCLE_EPOCHS = 2
LIFECYCLE_PATHS = ("resume", "test", "predict_ckpt")
DEEPLAB_LIFECYCLE = (COMPLEXES[0], COMPLEXES[2])  # the DeepLab lifecycle's two complexes


def _tree_diff(a, b) -> float:
    """Largest |a - b| over the tensors of two state dicts of one structure
    (inf where the structure or a non-tensor value differs)."""
    if isinstance(a, torch.Tensor):
        return (a.double() - b.double()).abs().max().item() if a.numel() else 0.0
    if isinstance(a, dict):
        if a.keys() != b.keys():
            return math.inf
        return max((_tree_diff(a[k], b[k]) for k in a), default=0.0)
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return math.inf
        return max((_tree_diff(x, y) for x, y in zip(a, b)), default=0.0)
    return 0.0 if a == b else math.inf


def _same_metric(a: float, b: float, tol: float) -> bool:
    return (math.isnan(a) and math.isnan(b)) or abs(a - b) <= tol


def _counted(fn):
    """(fn(), (K1, K2 launches, CSR builds) during it)."""
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, launches()


def _expect_launches(label, counts, encode_pairs, train_steps):
    expected = (LAUNCHES_PER_ENCODE_PAIR * encode_pairs, LAUNCHES_PER_ENCODE_PAIR * train_steps,
                BUILDS_PER_ENCODE_PAIR * encode_pairs)
    check(counts == expected, f"{label}: (K1, K2 launches, CSR builds) {counts}, expected "
          f"{expected}")


# On the card cli.train and cli.test replay one CUDA graph of the train
# step and one of the eval step per bucket key (training/step_graphs.py).
# The Python launch counters move at a key's capture, as its warm-up runs
# and the capture itself do (this many eager steps), and never at a replay.
GRAPH_COUNTED_RUNS = step_graphs.WARMUP_RUNS + 1


def _keys(batches) -> int:
    """Distinct step-graph keys (every tensor's shape) among ``batches``."""
    return len({step_graphs.batch_key(b) for b in batches})


def _split(root, split) -> list:
    """A split's batches at batch 1, in the loader's eval order."""
    return list(BucketedLoader(DIPSDataset(root, split)))


def _expect_graphed(label, counts, train_batches, eval_batches, eager_encode_pairs=0):
    """Exact (K1, K2, CSR builds) around a graphed cli.train / cli.test run
    that trained ``train_batches`` and evaluated ``eval_batches``: each
    train key's capture counts GRAPH_COUNTED_RUNS train steps, each eval
    key's as many eval steps, plus ``eager_encode_pairs`` eager forwards."""
    t, e = _keys(train_batches), _keys(eval_batches)
    _expect_launches(label, counts, GRAPH_COUNTED_RUNS * (t + e) + eager_encode_pairs,
                     GRAPH_COUNTED_RUNS * t)


def _train_argv(root, ckpt_dir, seed, *extra):
    """One step per dispatch: a run of the default 8 would pull a batch
    ahead before its preemption poll, and the fault plan would preempt
    before epoch 2's first batch instead of its second (phase 12 runs the
    default)."""
    return ["--dips_root", root, "--num_epochs", str(LIFECYCLE_EPOCHS), "--seed", str(seed),
            "--log_every", "0", "--ckpt_dir", ckpt_dir, "--steps_per_dispatch", "1", *extra]


def run_lifecycle(raw, seed, device, exact: bool, flags=(), sizes=COMPLEXES,
                  save_modes: bool = True) -> dict:
    """Phase 5b in a fresh directory, on a dataset of ``sizes``. ``exact``
    demands bitwise equality of the resumed and the uninterrupted run;
    otherwise losses and metrics within 1e-5 and weights and moments
    within 1e-4. ``flags`` go to every CLI call (the flagship's on the
    card, or ``--interact_module_type deeplab``; a CPU rehearsal passes a
    small model and ``--device cpu``). The fault plan preempts the run at
    epoch 2's second train batch. ``save_modes`` also runs the same
    training with epoch-boundary saves only (asynchronous and synchronous)
    and holds them to the uninterrupted run."""

    def train(ckpt_dir, *extra):
        args = train_cli.parse_args(_train_argv(root, ckpt_dir, seed, *extra, *flags))
        return _counted(lambda: train_cli.run(args))

    tol_metric, tol_state = (0.0, 0.0) if exact else (1e-5, 1e-4)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lifecycle_") as work:
        root = os.path.join(work, "data")
        write_tiny_npz_dataset(root, sizes=sizes, seed=seed, knn=constants.KNN,
                               geo_nbrhd_size=constants.GEO_NBRHD_SIZE)
        n_train = len(DIPSDataset(root, "train"))
        preempt_at = n_train + 2
        modes = ("epoch_saves", "sync_epoch_saves") if save_modes else ()
        dirs = {name: os.path.join(work, name) for name in ("whole", "preempted", *modes)}

        # The uninterrupted run, with a save after every step.
        (hist_a, test_a), counts_a = train(dirs["whole"], "--save_every_steps", "1")
        evals = _split(root, "val") + _split(root, "test")
        _expect_graphed("cli.train 2 epochs", counts_a, _split(root, "train"), evals)
        # The same with epoch-boundary saves only, written asynchronously
        # and synchronously.
        hist_c = hist_s = []
        if save_modes:
            (hist_c, _), _ = train(dirs["epoch_saves"])
            (hist_s, _), _ = train(dirs["sync_epoch_saves"], "--sync_checkpoint")
        # Preempted through the fault plan in mid-epoch 2, then resumed.
        faults.configure({"train.sigterm": [preempt_at]})
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                rc, counts_b = _counted(lambda: train_cli.main(_train_argv(
                    root, dirs["preempted"], seed, "--save_every_steps", "1", *flags)))
        finally:
            faults.reset()
        preempted_line = [line for line in out.getvalue().splitlines()
                          if line.startswith("training preempted (")]
        check(rc == 0 and len(preempted_line) == 1 and "rerun with --resume" in preempted_line[0],
              f"preempted cli.train: rc {rc}, output {out.getvalue()[-400:]!r}")
        log(f"  preempted run: rc {rc}, launches {counts_b}; {preempted_line[0]}")
        (hist_b, test_b), counts_resume = train(dirs["preempted"], "--save_every_steps", "1",
                                                 "--resume")
        remaining = LIFECYCLE_EPOCHS * n_train - (preempt_at - 1)
        # The batches the resumed run trains: epoch 2's plan from its second.
        resumed = list(BucketedLoader(DIPSDataset(root, "train"), shuffle=True,
                                      drop_remainder=True, seed=seed).iter_epoch(
            LIFECYCLE_EPOCHS - 1, start_batch=preempt_at - 1 - n_train))
        check(len(resumed) == remaining, f"resumed plan {len(resumed)} batches, {remaining} left")
        _expect_graphed("resumed cli.train", counts_resume, resumed, evals)

        ckpts = {name: Checkpointer(CheckpointConfig(directory=d)) for name, d in dirs.items()}
        finals = {name: ck.restore(None, which="last") for name, ck in ckpts.items()}
        state_diff = _tree_diff(finals["whole"], finals["preempted"])
        saves_diff = max((_tree_diff(finals["whole"], finals[name]) for name in modes),
                         default=0.0)
        check(state_diff <= tol_state, f"resumed run's last/ state differs from the uninterrupted "
              f"run's by {state_diff:.3g} (tol {tol_state})")
        check(saves_diff <= tol_state, f"mid-epoch saves changed training: {saves_diff:.3g}")
        check(len(hist_b) == 1 and hist_b[0]["epoch"] == LIFECYCLE_EPOCHS - 1,
              f"resumed history epochs {[h['epoch'] for h in hist_b]}")
        for key in ("train_loss", "val_ce", "train_steps"):
            check(_same_metric(hist_b[0][key], hist_a[-1][key], tol_metric),
                  f"resumed epoch {key} {hist_b[0][key]} vs uninterrupted {hist_a[-1][key]}")
        for key, value in test_a.items():
            check(_same_metric(test_b[key], value, tol_metric),
                  f"resumed run's {key} {test_b[key]} vs uninterrupted {value}")
        for name in ("preempted", *modes):
            check((ckpts[name].best_step(), ckpts[name].latest_step())
                  == (ckpts["whole"].best_step(), ckpts["whole"].latest_step()),
                  f"{name}: best/latest steps differ from the uninterrupted run's")
        side_a, side_b = read_sidecar(dirs["whole"]), read_sidecar(dirs["preempted"])
        check(side_a["epoch"] == side_b["epoch"] and side_a["stopper_stale"]
              == side_b["stopper_stale"] and _same_metric(side_a["stopper_best"],
                                                          side_b["stopper_best"], tol_metric),
              f"trainer_state.json differs: {side_a} vs {side_b}")
        log(f"  resume: {remaining} train steps after the restore, launches K1 "
            f"{counts_resume[0]} K2 {counts_resume[1]}, CSR builds {counts_resume[2]}; last/ "
            f"state vs uninterrupted max |diff| {state_diff:.3g}, vs the epoch-saves-only runs "
            f"{saves_diff:.3g} ({'bitwise' if exact else 'tolerance'}); best/latest step "
            f"{ckpts['whole'].best_step()}/{ckpts['whole'].latest_step()}")

        # cli.test from best/ against Trainer.evaluate of the restored state.
        test_args = test_cli.parse_args(["--dips_root", root, "--ckpt_name", dirs["whole"],
                                         "--seed", str(seed), "--csv_out",
                                         os.path.join(work, "test_top_metrics.csv"), *flags])
        metrics_t, counts_test = _counted(lambda: test_cli.run(test_args))
        _expect_graphed("cli.test", counts_test, [], _split(root, "test"))
        model = load_model(model_config_from_args(test_args), device, ckpt_name=dirs["whole"])
        trainer = Trainer(model)
        ref_t = trainer.evaluate(trainer.init_state(), BucketedLoader(DIPSDataset(root, "test")),
                                 stage="test")
        check(metrics_t.keys() == ref_t.keys() and all(
            _same_metric(metrics_t[k], v, 0.0) for k, v in ref_t.items()),
            f"cli.test metrics {metrics_t} differ from Trainer.evaluate's {ref_t}")
        # predict --ckpt_name against predict_complex of the restored model.
        npz, out_dir = os.path.join(work, "complex.npz"), os.path.join(work, "predict")
        save_complex_npz(npz, raw["graph1"], raw["graph2"], raw["examples"], complex_name="c")
        with contextlib.redirect_stdout(io.StringIO()):
            rc, counts_pred = _counted(lambda: predict_cli.main([
                "--input_npz", npz, "--output_dir", out_dir, "--ckpt_name", dirs["whole"],
                *flags]))
        _expect_launches("predict --ckpt_name", counts_pred, 1, 0)
        probs = np.load(os.path.join(out_dir, "contact_prob_map.npy"))
        ref_p = predict_complex(load_complex_npz(npz), model, device)["contact_prob_map"]
        check(rc == 0 and np.array_equal(probs, ref_p),
              f"predict --ckpt_name: rc {rc}, max |diff| vs the restored model "
              f"{np.abs(probs - ref_p).max():.3g}")
        log(f"  cli.test --ckpt_name: launches {counts_test}, metrics equal Trainer.evaluate's "
            f"(test_ce {metrics_t['test_ce']:.6f}); predict --ckpt_name: launches "
            f"{counts_pred}, probabilities equal the restored model's")
        epochs = {name: [{k: h[k] for k in ("train_seconds", "epoch_seconds",
                                             "checkpoint_seconds")} for h in hist]
                  for name, hist in (("save_every_step", hist_a), ("epoch_saves", hist_c),
                                     ("sync_epoch_saves", hist_s))}
        for name, rows in epochs.items():
            if not rows:
                continue
            log(f"  epoch wall ({name}): " + "; ".join(
                f"epoch {i}: train {r['train_seconds'] * 1e3:.1f} ms, epoch "
                f"{r['epoch_seconds'] * 1e3:.1f} ms, boundary save blocking "
                f"{r['checkpoint_seconds'] * 1e3:.1f} ms" for i, r in enumerate(rows)))
        return {"exact": exact, "resume_state_max_diff": state_diff,
                "launches": {"resume": counts_resume, "test": counts_test,
                             "predict_ckpt": counts_pred, "preempted": counts_b,
                             "train_2_epochs": counts_a},
                "epochs": epochs}


def time_checkpoint(state, runs: int = 5) -> dict:
    """A flagship train state's epoch-boundary save, synchronous: the host
    snapshot (device to host copy) and the write of best/ and last/ (two
    step directories, each payload + fsync + rename + integrity sidecar);
    then the restore of last/ (verification, torch.load onto the card,
    load into the state) and the verification alone. Medians of ``runs``,
    host clock, synchronized."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as work:
        ck = Checkpointer(CheckpointConfig(directory=work))
        snap, write = [], []
        for step in range(1, runs + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            payload = host_snapshot(state)
            t1 = time.perf_counter()
            ck.save(step, payload, {"val_ce": 1.0 / step})
            t2 = time.perf_counter()
            snap.append((t1 - t0) * 1e3)
            write.append((t2 - t1) * 1e3)
        step_dir = ck.step_dir("last", runs)
        nbytes = artifacts.read_sidecar(step_dir)["bytes"]
        device = next(state.model.parameters()).device
        restore, verify, load = [], [], []
        for _ in range(runs):
            t0 = time.perf_counter()
            artifacts.verify_tree(step_dir, kind=artifacts.CHECKPOINT_KIND)
            t1 = time.perf_counter()
            torch.load(os.path.join(step_dir, PAYLOAD), map_location=device, weights_only=True)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            ck.restore(state, which="last")
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            verify.append((t1 - t0) * 1e3)
            load.append((t2 - t1) * 1e3)
            restore.append((t3 - t2) * 1e3)
    out = {"step_bytes": nbytes, "snapshot_ms": statistics.median(snap),
           "write_best_and_last_ms": statistics.median(write),
           "sync_save_ms": statistics.median(a + b for a, b in zip(snap, write)),
           "restore_ms": statistics.median(restore), "verify_ms": statistics.median(verify),
           "torch_load_ms": statistics.median(load)}
    log(f"  checkpoint of the flagship state: {nbytes} B per step; sync save "
        f"{out['sync_save_ms']:.1f} ms (snapshot {out['snapshot_ms']:.1f} ms + write of best/ "
        f"and last/ {out['write_best_and_last_ms']:.1f} ms); restore {out['restore_ms']:.1f} ms "
        f"(of which, timed alone: verification {out['verify_ms']:.1f} ms, torch.load onto the "
        f"card {out['torch_load_ms']:.1f} ms); medians of {runs}")
    return out


# ---------------------------------------------------------------------------
# Phase 7: model configurations
# ---------------------------------------------------------------------------

TILED_COMPLEX = (600, 450)  # buckets 768 x 512: 3 x 2 tiles of 256 x 256
TILED_TRAIN = ((300, 200), (280, 210))  # buckets 512 x 256: two tiles per step
STEM_BAR = dict(rtol=1e-3, atol=1e-4)  # the JAX package's tests/test_stem.py
TILE_BAR = dict(rtol=4e-4, atol=1e-4)  # the JAX package's tests/test_tiled_decoder.py


def config_variants(cfg: ModelConfig) -> dict:
    """name -> (model config, which complexes it predicts: 'smoke' for the
    three of COMPLEXES, 'one' for the first, 'tiled' for TILED_COMPLEX)."""
    deeplab = dataclasses.replace(cfg, interact_module_type="deeplab")
    return {
        "deeplab": (deeplab, "smoke"),
        "deeplab_os8": (dataclasses.replace(deeplab, deeplab=dataclasses.replace(
            deeplab.deeplab, output_stride=8)), "one"),
        "tiled": (dataclasses.replace(cfg, tile_pair_map=True), "tiled"),
        "tiled_deeplab": (dataclasses.replace(deeplab, tile_pair_map=True), "tiled"),
        "gcn": (dataclasses.replace(cfg, gnn_layer_type="gcn"), "one"),
        "attention": (dataclasses.replace(cfg, decoder=dataclasses.replace(
            cfg.decoder, use_attention=True)), "one"),
        # Head dim 64: the kernels' paths beyond the flagship's D=32.
        "heads2": (dataclasses.replace(cfg, gnn=dataclasses.replace(cfg.gnn, num_heads=2)),
                   "one"),
    }


def plain_variant(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, gnn=dataclasses.replace(cfg.gnn, attention_impl="plain"))


def expected_predict_counts(cfg: ModelConfig) -> tuple:
    """(K1, K2, CSR builds) of one predict: the GT runs K1 in each of its
    2 layers of both encodes; the GCN launches no kernel; both build one
    in-edge CSR per encode."""
    k1 = 0 if cfg.gnn_layer_type == "gcn" else LAUNCHES_PER_ENCODE_PAIR
    return (k1, 0, BUILDS_PER_ENCODE_PAIR)


def rounding_spread(module, fn, base, seeds=(1, 2)) -> float:
    """Largest |fn() - base| (numpy arrays) when every parameter of
    ``module`` moves by 1e-7 relative (float32 rounding), one move per
    seed: how far float32 rounding alone moves the output. The weights
    are put back."""
    weights = {k: v.clone() for k, v in module.state_dict().items()}
    params = {k for k, _ in module.named_parameters()}
    spread = 0.0
    for s in seeds:
        gen = torch.Generator().manual_seed(s)
        module.load_state_dict({k: v * (1 + 1e-7 * torch.randn(v.shape, generator=gen)
                                        .to(v.device)) if k in params else v
                                for k, v in weights.items()})
        spread = max(spread, float(np.abs(fn() - base).max()))
    module.load_state_dict(weights)
    return spread


def run_config_predict(name, cfg, raws, seed, device, smi, runs) -> dict:
    """Predict each of ``raws`` with exact launch counts and peak memory,
    its logits against the plain attention's, and its encode / decode /
    wall times (medians of ``runs``). The logit bar is rtol 1e-4 and atol
    1e-4 plus four times the plain path's rounding spread
    (:func:`rounding_spread`), as compare_train_step's: the DeepLab
    decoder turns the encoder's ~1e-6 float32 differences between K1 and
    the plain attention into ~1e-4 on the logits, and moves as far when
    only the weights' rounding moves."""
    model = load_model(cfg, device, seed=seed)
    plain_model = load_model(plain_variant(cfg), device, seed=seed)
    plain_model.load_state_dict(model.state_dict())
    expected = expected_predict_counts(cfg)
    out = {"launches": (0, 0, 0), "max_logit_diff": 0.0, "complexes": []}
    for raw in raws:
        n1 = raw["graph1"]["node_feats"].shape[0]
        n2 = raw["graph2"]["node_feats"].shape[0]
        torch.cuda.reset_peak_memory_stats()
        res, counts = _counted(lambda: predict_complex(raw, model, device))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(counts == expected, f"predict {name} {n1}x{n2}: (K1, K2 launches, CSR builds) "
              f"{counts}, expected {expected}")
        probs = res["contact_prob_map"]
        check(probs.shape == (n1, n2) and bool(np.isfinite(probs).all()),
              f"predict {name} {n1}x{n2}: probabilities {probs.shape}, not finite in [0, 1]")
        ref, plain_counts = _counted(lambda: predict_complex(raw, plain_model, device))
        check(plain_counts[:2] == (0, 0), f"predict {name}: the plain path launched a kernel")
        diff = float(np.abs(ref["logits"] - res["logits"]).max())
        spread = rounding_spread(plain_model, lambda: predict_complex(
            raw, plain_model, device)["logits"], ref["logits"])
        check(np.allclose(res["logits"], ref["logits"], rtol=1e-4, atol=1e-4 + 4 * spread),
              f"predict {name} {n1}x{n2}: kernel vs plain logits differ by {diff:.3g} (rtol "
              f"1e-4, atol 1e-4 + 4 x spread {spread:.3g})")
        t = time_predict(model, raw, device, runs=runs)
        buckets = tuple(pick_bucket(n) for n in (n1, n2))
        log(f"  predict {name} {n1}x{n2} (buckets {buckets[0]}/{buckets[1]}): wall "
            f"{t['predict_wall_ms']:.3f} ms, encode x2 {t['encode_ms']:.3f} ms, decode "
            f"{t['decode_ms']:.3f} ms (median of {runs}); peak {peak:.3f} GiB; K1 {counts[0]} "
            f"K2 {counts[1]} CSR builds {counts[2]}; max |logits kernel - plain| {diff:.3g} "
            f"(rtol 1e-4, atol 1e-4 + 4 x spread {spread:.3g}); [{smi}]")
        out["launches"] = tuple(a + b for a, b in zip(out["launches"], counts))
        out["max_logit_diff"] = max(out["max_logit_diff"], diff)
        out["max_spread"] = max(out.get("max_spread", 0.0), spread)
        out["complexes"].append({"n": (n1, n2), "buckets": buckets, "peak_gib": peak,
                                 "logit_diff": diff, "spread": spread, **t})
    return out


def _encoded(model, raw, device):
    cx = stack_complexes([to_paired_complex(raw)]).to(device)
    f1, _ = model.encode(cx.graph1)
    f2, _ = model.encode(cx.graph2)
    return f1, f2, cx.graph1.node_mask, cx.graph2.node_mask


@torch.inference_mode()
def check_tiles_against_direct(name, model, raw, device) -> float:
    """Each tile of the tiled decode against the decoder run directly on
    that tile's chain slices (the JAX package's own oracle)."""
    model.eval()
    f1, f2, m1, m2 = _encoded(model, raw, device)
    tiled = model.decode(f1, f2, m1, m2)
    t = model.cfg.tile_size
    worst = 0.0
    for ti in range(f1.shape[1] // t):
        for tj in range(f2.shape[1] // t):
            rows, cols = slice(ti * t, (ti + 1) * t), slice(tj * t, (tj + 1) * t)
            direct = model.decoder(PairFactors(f1[:, rows], f2[:, cols], m1[:, rows],
                                               m2[:, cols]),
                                   m1[:, rows, None] & m2[:, None, cols])
            got = tiled[:, rows, cols]
            worst = max(worst, (got - direct).abs().max().item())
            check(torch.allclose(got, direct, **TILE_BAR),
                  f"{name}: tile ({ti}, {tj}) differs from its direct decode by {worst:.3g}")
    log(f"  {name}: {tiled.shape[1] // t}x{tiled.shape[2] // t} tiles, each within "
        f"{worst:.3g} of its direct decode (rtol 4e-4, atol 1e-4)")
    return worst


@torch.inference_mode()
def check_deeplab_stems(model, raw, device) -> tuple:
    """DeepLab's factorized stem (no [L1, L2, 2C] tensor) against the
    materialized one, on one complex's encoded chains, at the bar of the
    JAX package's tests/test_stem.py, its atol plus four times the
    materialized path's rounding spread over the decoder's weights
    (:func:`rounding_spread`): the stems are the same algebra, but at the
    flagship width each float32 stem carries ~1e-4 of rounding through the
    decoder's ~45 instance norms. Returns (max |diff|, spread)."""
    model.eval()
    f1, f2, m1, m2 = _encoded(model, raw, device)
    pm = m1[:, :, None] & m2[:, None, :]
    fact = model.decoder(PairFactors(f1, f2, m1, m2), pm)
    mat = model.decoder(interaction_tensor(f1, f2), pm)
    spread = rounding_spread(model.decoder, lambda: model.decoder(
        interaction_tensor(f1, f2), pm).cpu().numpy(), mat.cpu().numpy())
    diff = (fact - mat).abs().max().item()
    check(torch.allclose(fact, mat, rtol=STEM_BAR["rtol"], atol=STEM_BAR["atol"] + 4 * spread),
          f"DeepLab factorized vs materialized stem: logits differ by {diff:.3g} (rtol 1e-3, "
          f"atol 1e-4 + 4 x spread {spread:.3g})")
    log(f"  DeepLab stems: factorized vs materialized max |diff| {diff:.3g} (rtol 1e-3, atol "
        f"1e-4 + 4 x spread; spread {spread:.3g})")
    return diff, spread


def run_config_train(name, flags, sizes, seed, device, smi, runs, warmup=2, split=True) -> dict:
    """``cli.train`` for one epoch on ``sizes`` with ``flags``: exact launch
    counts, peak memory, finite losses; then a train step of the largest
    complex timed on its own (median of ``runs`` after ``warmup``)."""
    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{name}_") as root:
        write_tiny_npz_dataset(root, sizes=sizes, seed=seed, knn=constants.KNN,
                               geo_nbrhd_size=constants.GEO_NBRHD_SIZE)
        args = train_cli.parse_args(["--dips_root", root, "--num_epochs", "1", "--seed",
                                     str(seed), "--log_every", "0", "--ckpt_dir",
                                     os.path.join(root, "ckpt"), *flags])
        torch.cuda.reset_peak_memory_stats()
        (history, test), counts = _counted(lambda: train_cli.run(args))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        (epoch,) = history
        steps = int(epoch["train_steps"])
        check(steps == len(sizes), f"train {name}: {steps} steps, expected {len(sizes)}")
        _expect_graphed(f"train {name}", counts, _split(root, "train"),
                        _split(root, "val") + _split(root, "test"))
        check(epoch["train_skipped_steps"] == 0, f"train {name}: the guard skipped a step")
        for key, value in (("train_loss", epoch["train_loss"]), ("val_ce", epoch["val_ce"]),
                           ("test_ce", test["test_ce"])):
            check(math.isfinite(value), f"train {name}: {key} = {value}")
        batch = max(BucketedLoader(DIPSDataset(root, "train")),
                    key=lambda b: b.contact_map.numel())
    model = load_model(model_config_from_args(args), device, seed=seed)
    t = time_train_step(create_train_state(model, seed=seed), batch.to(device), runs=runs,
                        warmup=warmup, split=split)
    b1, b2 = batch.contact_map.shape[1:]
    parts = (f"; forward+loss {t['forward_ms']:.3f}, backward {t['backward_ms']:.3f}, "
             f"optimizer {t['optimizer_ms']:.3f}" if split else "")
    log(f"  cli.train {name} 1 epoch: {steps} train steps, launches K1 {counts[0]} K2 "
        f"{counts[1]}, CSR builds {counts[2]}, peak {peak:.3f} GiB, train_loss "
        f"{epoch['train_loss']:.4f}, val_ce {epoch['val_ce']:.4f}; train step {b1}/{b2}: "
        f"{t['train_step_ms']:.3f} ms (median of {runs}{parts}), peak "
        f"{t['max_memory_allocated_gb']:.3f} GiB; [{smi}]")
    return {"launches": counts, "train_steps": steps, "epoch_peak_gib": peak,
            "buckets": (int(b1), int(b2)), **t}


# Timing runs (medians) per path: maps of one tile, tiled maps, the DeepLab
# train step, the tiled train step. Cut as phases joined the script, to keep
# it inside half its time limit: from 20 / 5 / 5 / 3 to 3 / 2 / 2 / 1 with
# the serving phase, to 2 / 1 / 1 / 1 with the fleet phase, and to
# 1 / 1 / 1 / 1 with the dispatch-loop phase.
CONFIG_RUNS = {"predict": 1, "predict_tiled": 1, "train": 1, "train_tiled": 1}
# Cut to 2 and 1 with the step-graph phase (from 3 and 2).
PHASE6_PREDICT_RUNS = 2  # per complex (20, then 10, then 5 before the dispatch-loop phase)
PHASE6_TRAIN_RUNS = 1  # per batch (5, then 3, then 2)


def run_model_configs(cfg, raws, tiled_raw, seed, device, smi, runs=CONFIG_RUNS) -> dict:
    """Phase 7 on the flagship-width ``cfg``. Returns {path: result}."""
    results = {}
    for name, (vcfg, which) in config_variants(cfg).items():
        chosen = {"smoke": raws, "one": raws[:1], "tiled": [tiled_raw]}[which]
        results[f"predict_{name}"] = run_config_predict(
            name, vcfg, chosen, seed, device, smi,
            runs["predict_tiled" if which == "tiled" else "predict"])
        if name in ("tiled", "tiled_deeplab", "deeplab"):
            model = load_model(vcfg, device, seed=seed)
            if name == "deeplab":
                results["deeplab_stems"] = check_deeplab_stems(model, raws[0], device)
            else:
                results[f"{name}_tiles_max_diff"] = check_tiles_against_direct(
                    name, model, tiled_raw, device)
            del model
        torch.cuda.empty_cache()
    results["train_deeplab"] = run_config_train(
        "deeplab", ["--interact_module_type", "deeplab"], COMPLEXES, seed, device, smi,
        runs["train"])
    torch.cuda.empty_cache()
    results["train_tiled"] = run_config_train(
        "tiled", ["--tile_pair_map"], TILED_TRAIN, seed, device, smi, runs["train_tiled"])
    torch.cuda.empty_cache()
    results["train_heads2"] = run_config_train(
        "heads2", ["--num_gnn_attention_heads", "2"], COMPLEXES, seed, device, smi,
        runs["train"])
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# Phase 8a: decoder remat
# ---------------------------------------------------------------------------

REMAT_POLICIES = ("full", "convs")


def compare_remat_step(label, cfg, remat_cfg, batch, seed, device) -> dict:
    """One train step with remat against one without, from the same
    weights, batch and dropout seed, under deterministic algorithms: loss
    within 1e-5 and every gradient within 1e-4 (expected: equal), and each
    step's time and peak memory."""
    model = load_model(cfg, device, seed=seed)
    remat = load_model(remat_cfg, device, seed=seed)
    remat.load_state_dict(model.state_dict())
    batch = batch.to(device)
    out = {}
    torch.use_deterministic_algorithms(True)
    try:
        for name, m in (("plain", model), ("remat", remat)):
            weights = {k: v.clone() for k, v in model.state_dict().items()}
            m.load_state_dict(weights)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss = loss_and_grads(m, batch, seed)
            torch.cuda.synchronize()
            out[name] = (loss.item(), {n: p.grad.detach().clone()
                                       for n, p in m.named_parameters()},
                         (time.perf_counter() - t0) * 1e3,
                         torch.cuda.max_memory_allocated() / 2 ** 30)
            m.load_state_dict(weights)  # the step moved the batch statistics
    finally:
        torch.use_deterministic_algorithms(False)
    loss_diff = abs(out["remat"][0] - out["plain"][0])
    grad_diff = max((out["remat"][1][n] - g).abs().max().item()
                    for n, g in out["plain"][1].items())
    check(loss_diff <= 1e-5, f"{label}: remat loss differs by {loss_diff:.3g}")
    for n, g in out["plain"][1].items():
        check(torch.allclose(out["remat"][1][n], g, rtol=1e-4, atol=1e-4),
              f"{label}: remat grad {n} differs by {(out['remat'][1][n] - g).abs().max():.3g}")
    log(f"  {label}: remat vs plain step |loss diff| {loss_diff:.3g} (tol 1e-5), max |grad "
        f"diff| {grad_diff:.3g} (tol 1e-4); first step wall plain {out['plain'][2]:.1f} ms / "
        f"{out['plain'][3]:.3f} GiB, remat {out['remat'][2]:.1f} ms / {out['remat'][3]:.3f} GiB")
    del model, remat
    torch.cuda.empty_cache()
    return {"loss_diff": loss_diff, "max_grad_diff": grad_diff,
            "plain_peak_gib": out["plain"][3], "remat_peak_gib": out["remat"][3]}


def run_remat(cfg, seed, device, smi, runs) -> dict:
    """Phase 8a: remat against no remat on a two-tile map (each policy) and
    on a DeepLab step; then one ``cli.train`` epoch of a six-tile complex
    with ``--tile_pair_map --remat`` per policy (peak memory, step time),
    beside the two-tile step's time with and without remat."""
    log("== phase 8a: decoder remat (--remat, --remat_policy)")
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_remat_") as root:
        write_tiny_npz_dataset(root, sizes=TILED_TRAIN[:1] + COMPLEXES[1:2], seed=seed,
                               knn=constants.KNN, geo_nbrhd_size=constants.GEO_NBRHD_SIZE)
        batches = list(BucketedLoader(DIPSDataset(root, "train")))
    tiled_batch = max(batches, key=lambda b: b.contact_map.numel())
    smoke_batch = min(batches, key=lambda b: b.contact_map.numel())
    tiled = dataclasses.replace(cfg, tile_pair_map=True)
    for policy in REMAT_POLICIES:
        remat = dataclasses.replace(tiled, decoder=dataclasses.replace(
            tiled.decoder, remat=True, remat_policy=policy))
        out[f"tiled_two_tiles_{policy}"] = compare_remat_step(
            f"tiled 300x200 (two tiles), remat {policy}", tiled, remat, tiled_batch, seed,
            device)
    deeplab = dataclasses.replace(cfg, interact_module_type="deeplab")
    out["deeplab"] = compare_remat_step(
        "DeepLab 200x180", deeplab, dataclasses.replace(deeplab, deeplab=dataclasses.replace(
            deeplab.deeplab, remat=True)), smoke_batch, seed, device)
    # The two-tile step timed with and without remat, for the per-tile ratio.
    for name, c in (("no_remat", tiled), ("remat_full", dataclasses.replace(
            tiled, decoder=dataclasses.replace(tiled.decoder, remat=True)))):
        t = time_train_step(create_train_state(load_model(c, device, seed=seed), seed=seed),
                            tiled_batch.to(device), runs=runs, warmup=1, split=False)
        out[f"two_tile_step_{name}"] = t
        log(f"  two-tile train step ({name}): {t['train_step_ms']:.3f} ms (median of {runs}), "
            f"peak {t['max_memory_allocated_gb']:.3f} GiB; [{smi}]")
        torch.cuda.empty_cache()
    for policy in REMAT_POLICIES:
        out[f"train_six_tiles_{policy}"] = run_config_train(
            f"tiled_remat_{policy}", ["--tile_pair_map", "--remat", "--remat_policy", policy],
            [TILED_COMPLEX], seed, device, smi, runs=1, warmup=1, split=False)
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 8b: the reference-checkpoint importer
# ---------------------------------------------------------------------------

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden",
                      "full_model_parity.npz")
GRAPH_FIELDS = ("node_feats", "coords", "edge_feats", "nbr_idx", "src_nbr_eids",
                "dst_nbr_eids", "node_mask", "num_nodes")


def write_lightning_ckpt(path, sd, hparams) -> None:
    """A reference state dict as a Lightning checkpoint's two keys."""
    torch.save({"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in sd.items()},
                "hyper_parameters": dict(hparams)}, path)


def _quiet(fn):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = fn()
    return rc, out.getvalue()


def run_importer(cfg, raws, seed, device, flags=()) -> dict:
    """Phase 8b: the golden fixture's reference state dict as a Lightning
    ``.ckpt`` through ``cli.import_checkpoint`` and the ``cli.predict
    --ckpt_name`` loader on the card against its reference logits; a
    flagship-width reference ``.ckpt`` imported, predicted (kernel path
    against the plain path), tested by ``cli.test`` directly, and
    fine-tuned for one step. ``flags`` (the model of ``cfg``; ``--device
    cpu``) go to the flagship's CLI calls, for a CPU rehearsal."""
    from deepinteract_tpu_torch.cli import import_checkpoint as import_cli
    from deepinteract_tpu_torch.data.graph import ProteinGraph
    from deepinteract_tpu_torch.training.import_torch import synthesize_reference_state_dict

    log("== phase 8b: reference-checkpoint importer (cli.import_checkpoint, --ckpt_name)")
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_import_") as work:
        with np.load(GOLDEN) as z:
            data = {k: z[k] for k in z.files}
        sd = {k[len("sd/"):]: v for k, v in data.items() if k.startswith("sd/")}
        meta = {k[len("meta/"):]: int(v) for k, v in data.items() if k.startswith("meta/")}
        golden_ckpt = os.path.join(work, "golden.ckpt")
        write_lightning_ckpt(golden_ckpt, sd, {})
        golden_flags = ["--num_gnn_hidden_channels", str(meta["hidden"]),
                        "--num_gnn_attention_heads", str(meta["heads"]),
                        "--num_interact_layers", str(meta["num_chunks"]),
                        "--num_interact_hidden_channels", str(meta["hidden"]),
                        "--node_count_limit", str(meta["limit"])]
        rc, text = _quiet(lambda: import_cli.main(
            ["--ckpt", golden_ckpt, "--out_dir", os.path.join(work, "golden"), *golden_flags,
             "--device", str(device)]))
        check(rc == 0, f"cli.import_checkpoint of the golden .ckpt: rc {rc}")
        log(f"  golden .ckpt ({len(sd)} reference keys): {text.strip().splitlines()[0]}")
        golden_cfg = model_config_from_args(build_parser("x").parse_args(golden_flags))
        model = load_model(golden_cfg, device, ckpt_name=os.path.join(work, "golden"))
        graphs = [ProteinGraph(**{f: torch.from_numpy(data[f"cx/{leg}/{f}"]) for f in
                                  GRAPH_FIELDS}).to(device) for leg in ("graph1", "graph2")]
        with torch.inference_mode():
            logits, counts = _counted(lambda: model(*graphs))
        logits = logits.permute(0, 3, 1, 2).float().cpu().numpy()
        diff = float(np.abs(logits - data["ref_logits"]).max())
        _expect_launches("golden predict", counts, 1, 0)
        check(np.allclose(logits, data["ref_logits"], rtol=1e-4, atol=1e-4),
              f"golden logits differ from the reference's by {diff:.3g}")
        log(f"  golden predict --ckpt_name on the card: max |logits - ref_logits| {diff:.3g} "
            f"(rtol 1e-4, atol 1e-4); launches {counts}")
        out["golden_max_logit_diff"], out["golden_launches"] = diff, counts

        # A flagship-width reference checkpoint.
        ref_sd = synthesize_reference_state_dict(cfg, seed=seed)
        flag_ckpt = os.path.join(work, "flagship.ckpt")
        write_lightning_ckpt(flag_ckpt, ref_sd, {"num_gnn_hidden_channels": cfg.gnn.hidden,
                                                 "num_gnn_attention_heads": cfg.gnn.num_heads})
        imported = os.path.join(work, "flagship")
        rc, _ = _quiet(lambda: import_cli.main(["--ckpt", flag_ckpt, "--out_dir", imported,
                                                *flags]))
        check(rc == 0, f"cli.import_checkpoint of the flagship .ckpt: rc {rc}")
        model = load_model(cfg, device, ckpt_name=imported)
        plain_model = load_model(plain_variant(cfg), device, ckpt_name=imported)
        res, counts = _counted(lambda: predict_complex(raws[0], model, device))
        ref = predict_complex(raws[0], plain_model, device)["logits"]
        diff = float(np.abs(res["logits"] - ref).max())
        _expect_launches("imported predict", counts, 1, 0)
        check(np.allclose(res["logits"], ref, rtol=1e-4, atol=1e-4),
              f"imported flagship: kernel vs plain logits differ by {diff:.3g}")
        npz = os.path.join(work, "c.npz")
        save_complex_npz(npz, raws[0]["graph1"], raws[0]["graph2"], raws[0]["examples"], "c")
        (rc, _), counts_cli = _counted(lambda: _quiet(lambda: predict_cli.main([
            "--input_npz", npz, "--output_dir", os.path.join(work, "pred"), "--ckpt_name",
            imported, *flags])))
        probs = np.load(os.path.join(work, "pred", "contact_prob_map.npy"))
        check(rc == 0 and np.array_equal(probs, res["contact_prob_map"]),
              "cli.predict --ckpt_name <imported> differs from the loaded model")
        _expect_launches("cli.predict --ckpt_name <imported>", counts_cli, 1, 0)
        log(f"  flagship reference .ckpt ({len(ref_sd)} keys) imported: kernel vs plain "
            f"logits {diff:.3g} (tol 1e-4), cli.predict --ckpt_name launches {counts_cli}")
        out["flagship_max_logit_diff_vs_plain"] = diff

        root = os.path.join(work, "data")
        write_tiny_npz_dataset(root, sizes=COMPLEXES[:1], seed=seed, knn=constants.KNN,
                               geo_nbrhd_size=constants.GEO_NBRHD_SIZE)
        test_args = test_cli.parse_args(["--dips_root", root, "--ckpt_name", flag_ckpt,
                                         "--csv_out", os.path.join(work, "top.csv"), *flags])
        metrics, counts_test = _counted(lambda: _quiet(lambda: test_cli.run(test_args))[0])
        _expect_graphed("cli.test --ckpt_name <file.ckpt>", counts_test, [], _split(root, "test"))
        trainer = Trainer(model)
        ref_t = trainer.evaluate(trainer.init_state(), BucketedLoader(DIPSDataset(root, "test")),
                                 stage="test")
        check(all(_same_metric(metrics[k], v, 0.0) for k, v in ref_t.items()),
              f"cli.test on the .ckpt: {metrics} vs the imported model's {ref_t}")
        ft = train_cli.parse_args(["--dips_root", root, "--num_epochs", "1", "--fine_tune",
                                   "--ckpt_name", imported, "--ckpt_dir",
                                   os.path.join(work, "ft"), "--log_every", "0",
                                   "--seed", str(seed), *flags])
        (history, _), counts_ft = _counted(lambda: train_cli.run(ft))
        _expect_graphed("cli.train --fine_tune --ckpt_name <imported>", counts_ft,
                        _split(root, "train"), _split(root, "val") + _split(root, "test"))
        check(math.isfinite(history[0]["train_loss"]), "fine-tune: train_loss not finite")
        log(f"  cli.test --ckpt_name flagship.ckpt: launches {counts_test}, metrics equal the "
            f"imported model's (test_ce {metrics['test_ce']:.6f}); --fine_tune --ckpt_name "
            f"<imported>: 1 step, launches {counts_ft}, train_loss "
            f"{history[0]['train_loss']:.4f}")
        out["launches"] = {"golden": out["golden_launches"], "test_ckpt": counts_test,
                           "predict_ckpt": counts_cli, "fine_tune": counts_ft}
    return out


# ---------------------------------------------------------------------------
# Phase 8c: the training supervisor
# ---------------------------------------------------------------------------

HANG_AT = 2  # the second train batch of the first epoch
# A healthy child stamps progress at least every ~1.5 s (a flagship step is
# ~0.5 s, an eval ~0.2 s, a save ~1 s on the card) and beats every 2 s.
HANG_TIMEOUT_S = 10.0
HEARTBEAT_S = 2.0


def _cli_train(root, ckpt_dir, seed, *extra, faults_plan=None, flags=()):
    """Start ``cli.train`` on ``root`` in a process of its own; returns the
    Popen (text pipes). One step per dispatch: the hang is injected at the
    second batch, after the first step stamped progress; a run of the
    default 8 pulls the second batch before the first step, and a child
    that hangs before any progress waits out the start grace."""
    env = {k: v for k, v in os.environ.items() if k != "DI_FAULTS"}
    if faults_plan:
        env["DI_FAULTS"] = faults_plan
    return subprocess.Popen(
        [sys.executable, "-m", "deepinteract_tpu_torch.cli.train", "--dips_root", root,
         "--num_epochs", "1", "--seed", str(seed), "--log_every", "0", "--ckpt_dir",
         ckpt_dir, "--save_every_steps", "1", "--deterministic", "--test_csv",
         ckpt_dir + "_top.csv", "--steps_per_dispatch", "1", *flags, *extra],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _finish(proc, label):
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise SystemExit(f"chip_smoke FAILED: {label} did not end within 600 s")
    check(proc.returncode == 0, f"{label}: rc {proc.returncode}\n{out[-2000:]}\n{err[-2000:]}")
    return out


def run_supervisor(seed, flags=(), hang_timeout_s=HANG_TIMEOUT_S) -> dict:
    """Phase 8c: ``cli.train --supervise`` at the flagship width with a hang
    injected at the second train batch: one restart for a hang, a
    ``train_supervise/v1`` record that ``tools/check_cli_contract.py``
    accepts, and the final state within the bars of an unsupervised run of
    the same command (losses and metrics 1e-5, weights 1e-4). Both run
    with ``--deterministic``: without it the two runs' weights differed by
    3.77e-4 in the first card run of this phase. Kernels outside
    deterministic mode (cuDNN's, atomics) choose their own sum orders, so
    a difference of that size cannot tell a faulty resume from noise. ``flags`` go
    to both commands (a CPU rehearsal's small model and ``--device cpu``)."""
    log("== phase 8c: training supervisor (cli.train --supervise, training.hang)")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_supervise_") as work:
        root = os.path.join(work, "data")
        write_tiny_npz_dataset(root, sizes=COMPLEXES, seed=seed, knn=constants.KNN,
                               geo_nbrhd_size=constants.GEO_NBRHD_SIZE)
        # The two commands run side by side on the card.
        t0 = time.perf_counter()
        plain = _cli_train(root, os.path.join(work, "plain"), seed, flags=flags)
        sup = _cli_train(root, os.path.join(work, "sup"), seed, "--supervise",
                         "--hang_timeout_s", str(hang_timeout_s), "--start_grace_s", "600",
                         "--heartbeat_seconds", str(HEARTBEAT_S),
                         "--train_restart_backoff_s", "0", faults_plan=f"training.hang=@{HANG_AT}",
                         flags=flags)
        sup_out = _finish(sup, "supervised cli.train")
        t2 = time.perf_counter()
        _finish(plain, "unsupervised cli.train")
        t1 = time.perf_counter()
        record = json.loads(sup_out.strip().splitlines()[-1])
        contract = subprocess.run(
            [sys.executable, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                                          "check_cli_contract.py"), "train_supervise", "-"],
            input=sup_out, capture_output=True, text=True, timeout=60)
        check(contract.returncode == 0, f"train_supervise record refused: {contract.stderr}")
        check((record["restarts"], record["hang_kills"], record["crashes"], record["ok"])
              == (1, 1, 0, True), f"supervisor record {record}")
        check("SIGKILL" in sup_out, "the supervisor's log names no kill")
        cks = {name: Checkpointer(CheckpointConfig(directory=os.path.join(work, name)))
               for name in ("plain", "sup")}
        finals = {name: ck.restore(None, which="last") for name, ck in cks.items()}
        weight_diff = _tree_diff(finals["plain"], finals["sup"])
        metric = {name: ck._metrics("best", ck.steps("best")[-1]) for name, ck in cks.items()}
        metric_diff = max(abs(metric["plain"][k] - metric["sup"][k]) for k in metric["plain"]
                          if not k.endswith("_seconds") and math.isfinite(metric["plain"][k]))
        csvs = {name: np.genfromtxt(os.path.join(work, f"{name}_top.csv"), delimiter=",",
                                    skip_header=1, usecols=range(1, 7))
                for name in ("plain", "sup")}
        test_diff = float(np.nanmax(np.abs(csvs["plain"] - csvs["sup"])))
        check(weight_diff <= 1e-4, f"supervised run's last/ state differs by {weight_diff:.3g}")
        check(metric_diff <= 1e-5 and test_diff <= 1e-5,
              f"supervised run's metrics differ: epoch {metric_diff:.3g}, test {test_diff:.3g}")
        log(f"  supervised run: 1 restart (hang, killed after {hang_timeout_s:.0f} s without "
            f"progress), record accepted by tools/check_cli_contract.py; vs the unsupervised "
            f"run: last/ state max |diff| {weight_diff:.3g} (tol 1e-4), epoch metrics "
            f"{metric_diff:.3g}, test metrics {test_diff:.3g} (tol 1e-5); wall (side by "
            f"side) supervised {t2 - t0:.1f} s, both {t1 - t0:.1f} s")
        return {"record": record, "state_max_diff": weight_diff,
                "epoch_metric_max_diff": metric_diff, "test_metric_max_diff": test_diff,
                "wall_s": {"supervised": t2 - t0, "both": t1 - t0}}


# ---------------------------------------------------------------------------
# Phase 9: serving (one CUDA graph per bucket)
# ---------------------------------------------------------------------------

# Warm-up keys (bucket_n1 x bucket_n2 x batch slots): the buckets of
# COMPLEXES, four slots of one, and the over-bucket 600x450 -> 768x512.
SERVE_WARMUP = ((128, 128, 1), (256, 192, 1), (64, 256, 1), (256, 192, 4),
                TILED_COMPLEX + (1,))
# Timed requests per bucket (the tiled key's too), each side: 10, cut to 5
# with the step-graph phase and to 3 with the front-end phase.
SERVE_RUNS = 3


def _served_batch(engine, raws):
    """The graph-cache key and the stacked host batch that the engine's
    ``_flush`` replays for ``raws`` coalesced (one bucket)."""
    bucket_key = engine._bucket_key(raws[0])
    batch, slots = engine._assemble(raws, bucket_key)
    return bucket_key + (slots,), batch


def check_replays(engine, plain_model, batches, device) -> dict:
    """Each warm key's replay on its served batch against the eager forward
    on the same static batch (bitwise, else <= 1e-6) and, with a
    ``plain_model``, against the plain attention's forward (phase 4's bar:
    rtol 1e-4, atol 1e-4)."""
    from deepinteract_tpu_torch.serving.graphs import serve_forward

    out = {}
    for key, batch in batches.items():
        label = engine._key_label(key)
        g1, g2 = batch.graph1.to(device), batch.graph2.to(device)
        with engine._exec_lock, torch.inference_mode():
            replayed = engine._entries[key].replay(batch.graph1, batch.graph2).clone()
            eager = serve_forward(engine.model, g1, g2)
            plain = None if plain_model is None else serve_forward(plain_model, g1, g2)
        bitwise = bool(torch.equal(replayed, eager))
        eager_diff = float((replayed - eager).abs().max())
        check(bitwise or eager_diff <= 1e-6,
              f"replay {label} vs eager forward: {eager_diff:.3g} (bitwise or <= 1e-6)")
        out[label] = {"bitwise_vs_eager": bitwise, "max_abs_diff_vs_eager": eager_diff}
        msg = (f"  replay {label}: vs eager forward "
               f"{'bitwise equal' if bitwise else f'max |diff| {eager_diff:.3g} (bar 1e-6)'}")
        if plain is not None:
            plain_diff = float((replayed - plain).abs().max())
            check(torch.allclose(replayed, plain, rtol=1e-4, atol=1e-4),
                  f"replay {label} vs the plain attention's forward: {plain_diff:.3g} "
                  "(rtol 1e-4, atol 1e-4)")
            out[label]["max_abs_diff_vs_plain"] = plain_diff
            msg += f", vs plain attention max |diff| {plain_diff:.3g} (rtol 1e-4, atol 1e-4)"
        log(msg)
    return out


def profile_replay(engine, key, *inputs) -> dict:
    """One replay of ``key`` on ``inputs`` under torch.profiler: K1 kernels
    and all device kernels listed in it (0 and 0 if the profiler lists no
    kernel inside a graph)."""
    from torch.profiler import ProfilerActivity, profile

    entry = engine._entries[key]
    with engine._exec_lock:
        entry.replay(*inputs)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            entry.replay(*inputs)
            torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"k1": sum("edge_attention_fwd" in e.name for e in kernels),
            "kernels": len(kernels)}


def profile_graph(engine, entry) -> dict:
    """One replay of an entry's graph on its static inputs under
    torch.profiler: K1 kernels and all device kernels listed in it."""
    from torch.profiler import ProfilerActivity, profile

    with engine._exec_lock:
        entry.graph.replay()  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            entry.graph.replay()
            torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"k1": sum("edge_attention_fwd" in e.name for e in kernels),
            "kernels": len(kernels)}


def _post(host, port, path, body, headers, timeout=120):
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", path, body=body, headers=headers)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _get(host, port, path, timeout=30):
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, (data.decode() if path == "/metrics" else json.loads(data))
    finally:
        conn.close()


def _npz_bytes(raw) -> bytes:
    buf = io.BytesIO()
    save_complex_npz(buf, raw["graph1"], raw["graph2"], raw["examples"], "smoke")
    return buf.getvalue()


def _metric(text: str, name: str) -> float:
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[-1])
    raise KeyError(name)


def run_http(engine, raw) -> dict:
    """ServingServer on a free port: POST /predict (npz, ?trace=1), the GET
    routes against stats(), then a drain with one request in flight."""
    from deepinteract_tpu_torch.robustness.preemption import PreemptionGuard
    from deepinteract_tpu_torch.serving import SchedulerClosed, ServingServer

    server = ServingServer(engine, port=0)
    guard = PreemptionGuard(log=lambda s: None)  # flag-only off the main thread
    rc = {}
    runner = threading.Thread(target=lambda: rc.setdefault("rc", server.run(guard=guard)))
    runner.start()
    t_end = time.monotonic() + 10
    while server._serve_thread is None and time.monotonic() < t_end:
        time.sleep(0.01)
    host, port = server.address
    body = _npz_bytes(raw)
    status, out = _post(host, port, "/predict?trace=1", body,
                        {"Content-Type": "application/octet-stream"})
    check(status == 200 and len(out["trace_id"]) == 16 and out["trace"]["device_ms"] > 0,
          f"HTTP /predict: status {status}, {str(out)[:200]}")
    phases = {k: out["trace"][f"{k}_ms"] for k in ("queue_wait", "batch_assembly",
                                                    "compile", "device")}
    probs = np.asarray(out["contact_probs"])
    direct = engine.predict(raw)["probs"]
    check(probs.shape == direct.shape and float(np.abs(probs - direct).max()) <= 1e-6,
          "HTTP /predict probabilities differ from the engine's")
    status, health = _get(host, port, "/healthz")
    stats = engine.stats()
    check(status == 200 and health["status"] == "ok" and health["mesh_shape"] == "1x1"
          and health["warm_buckets"] == sorted(stats["compiled_buckets"]),
          f"/healthz {health}")
    status, sstats = _get(host, port, "/stats")
    status_m, text = _get(host, port, "/metrics")
    check(status == 200 and status_m == 200, "/stats or /metrics not 200")
    for name, want in (("di_serving_compiled_executables",
                        sstats["engine"]["num_compiled_executables"]),
                       ("di_serving_compiles_total", sstats["engine"]["capture_count"]),
                       ("di_serving_executed_requests_total",
                        sstats["engine"]["executed_requests"]),
                       ("di_serving_request_latency_seconds_count", sstats["latency"]["count"])):
        got = _metric(text, name)
        check(got == want, f"/metrics {name} {got} != /stats {want}")
    # Drain with a request in flight: the worker is held at the exec lock,
    # the drain waits for it, a POST meanwhile gets 503, and the held
    # request completes once the lock is released.
    engine._exec_lock.acquire()
    try:
        inflight = engine.submit(random_raw_complex(90, 70, np.random.default_rng(7)))
        time.sleep(0.05)
        guard.request("smoke drain")
        t_end = time.monotonic() + 10
        while not server._draining.is_set() and time.monotonic() < t_end:
            time.sleep(0.01)
        status_503, _ = _post(host, port, "/predict", body,
                              {"Content-Type": "application/octet-stream"})
    finally:
        engine._exec_lock.release()
    done = inflight.result(timeout=60)
    runner.join(timeout=60)
    check(status_503 == 503, f"POST while draining: {status_503}, expected 503")
    check(done["probs"].shape == (90, 70) and not runner.is_alive() and rc.get("rc") == 0,
          "the in-flight request or the drain did not complete")
    try:
        engine.submit(raw)
        check(False, "the engine accepted a request after the drain")
    except SchedulerClosed:
        pass
    return {"trace_phases_ms": phases, "status_while_draining": status_503}


def run_serving(cfg, raws, tiled_raw, seed, device, smi) -> dict:
    """Phase 9: InferenceEngine at the flagship width on the card."""
    from deepinteract_tpu_torch.obs.reqtrace import RequestTrace
    from deepinteract_tpu_torch.serving import EngineConfig, InferenceEngine

    log("== phase 9: serving (InferenceEngine, one CUDA graph per bucket, flagship width)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, cfg=EngineConfig(max_batch=4, warmup_buckets=SERVE_WARMUP,
                                                   result_cache_size=0),
                             seed=seed, device=device)
    construct_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    reserved_gib = torch.cuda.memory_reserved() / 2 ** 30
    stats = engine.stats()
    captures = stats["capture_count"]
    inventory = stats["compile_inventory"]
    check(captures == len(SERVE_WARMUP) == len(inventory),
          f"{captures} captures for {len(SERVE_WARMUP)} warm-up keys: {sorted(inventory)}")
    # (K1, K2 launches, CSR builds) during each key's capture, as measured.
    counted = {label: (info["k1_launches"], info["k2_launches"], info["csr_builds"])
               for label, info in inventory.items()}
    for label, info in inventory.items():
        log(f"  capture {label}: {info['seconds']:.3f} s, (K1, K2, CSR builds) "
            f"{counted[label]}")
    check(len(set(counted.values())) == 1, f"captures counted differently: {counted}")
    per_capture = next(iter(counted.values()))
    check(per_capture == (LAUNCHES_PER_ENCODE_PAIR, 0, BUILDS_PER_ENCODE_PAIR),
          f"each capture counted (K1, K2, CSR builds) {per_capture}, expected "
          f"{(LAUNCHES_PER_ENCODE_PAIR, 0, BUILDS_PER_ENCODE_PAIR)}")
    log(f"  engine construction (weights + {captures} captures) {construct_s:.3f} s; peak "
        f"memory after warm-up {peak_gib:.3f} GiB allocated, {reserved_gib:.3f} GiB reserved")
    ref_model = engine.model

    # Served against predict_complex at the same bucket (the one-shot path,
    # eager, on the same model), each complex alone.
    served_vs_predict = []
    for (n1, n2), raw in zip(COMPLEXES, raws):
        got = engine.predict(raw)
        ref = predict_complex(raw, ref_model, device)["contact_prob_map"]
        diff = float(np.abs(got["probs"] - ref).max())
        served_vs_predict.append(diff)
        check(got["probs"].shape == (n1, n2) and diff <= 1e-6,
              f"served {n1}x{n2} vs predict_complex: {diff:.3g} (bar 1e-6)")
    # A slot of a coalesced batch of four against the same complex alone.
    group = [raws[1]] + [random_raw_complex(201 + i, 181 + i, np.random.default_rng(seed + i))
                         for i in range(3)]
    futures = [engine.submit(raw) for raw in group]
    coalesced = [f.result(timeout=120) for f in futures]
    check(all(r["coalesced"] == 4 and r["batch_slots"] == 4 for r in coalesced),
          f"four concurrent submits coalesced as {[r['coalesced'] for r in coalesced]}")
    slot_diff = max(float(np.abs(r["probs"] - engine.predict(raw)["probs"]).max())
                    for r, raw in zip(coalesced, group))
    check(slot_diff <= 1e-5, f"coalesced slot vs served alone: {slot_diff:.3g} (bar 1e-5)")
    # The over-bucket request against predict_complex with tile_pair_map.
    tiled = engine.predict(tiled_raw)
    tiled_ref = predict_complex(tiled_raw, ref_model, device)["contact_prob_map"]
    tiled_diff = float(np.abs(tiled["probs"] - tiled_ref).max())
    check(tiled["bucket"] == (768, 512) and tiled_diff <= 1e-4,
          f"over-bucket {TILED_COMPLEX}: bucket {tiled['bucket']}, {tiled_diff:.3g} from "
          "predict_complex (bar 1e-4)")
    log(f"  served vs predict_complex: {max(served_vs_predict):.3g} (bar 1e-6); coalesced "
        f"slot vs alone {slot_diff:.3g} (bar 1e-5); over-bucket 768x512 {tiled_diff:.3g} "
        "(bar 1e-4)")

    # Every warm key's replay on its served batch, against the eager forward
    # and the plain attention on the same static batch.
    batches = dict(_served_batch(engine, rs) for rs in ([raws[0]], [raws[1]], [raws[2]],
                                                        group, [tiled_raw]))
    check(set(batches) == set(engine._entries),
          f"served batches {sorted(map(engine._key_label, batches))} are not the warm keys")
    plain_model = load_model(plain_variant(ref_model.cfg), device, seed=seed)
    plain_model.load_state_dict(ref_model.state_dict())
    replay_checks = check_replays(engine, plain_model, batches, device)
    del plain_model
    key4, batch4 = _served_batch(engine, group)
    prof = profile_replay(engine, key4, batch4.graph1, batch4.graph2)
    listed = prof["kernels"] > 0
    check(not listed or prof["k1"] == LAUNCHES_PER_ENCODE_PAIR,
          f"profiled replay: {prof['k1']} K1 kernels of {prof['kernels']}, expected "
          f"{LAUNCHES_PER_ENCODE_PAIR}")
    log(f"  profiled replay: " + (f"{prof['k1']} K1 kernels among {prof['kernels']} device "
                                  "kernels" if listed else
                                  "torch.profiler listed no kernel inside the graph"))

    # Times, host to host, warm: a replayed request per bucket beside eager
    # predict_complex at the same bucket.
    times = {}
    for (n1, n2), raw in list(zip(COMPLEXES, raws)) + [(TILED_COMPLEX, tiled_raw)]:
        walls, dispatch = [], []
        for _ in range(SERVE_RUNS):
            rt = RequestTrace("/predict")
            t0 = time.perf_counter()
            out = engine.predict(raw, reqtrace=rt)
            walls.append((time.perf_counter() - t0) * 1e3)
            tr = out["trace"]
            dispatch.append(tr["batch_assembly_ms"] + tr["compile_ms"] + tr["device_ms"])
        eager_walls = []
        for _ in range(SERVE_RUNS):
            t0 = time.perf_counter()
            predict_complex(raw, ref_model, device)
            eager_walls.append((time.perf_counter() - t0) * 1e3)
        label = "x".join(map(str, engine.bucket_for(n1, n2)))
        times[label] = {"served_ms": statistics.median(walls),
                        "dispatch_ms": statistics.median(dispatch),
                        "eager_predict_ms": statistics.median(eager_walls)}
        log(f"  {n1}x{n2} (bucket {label}): served {times[label]['served_ms']:.3f} ms (of "
            f"which assembly + replay + fetch {times[label]['dispatch_ms']:.3f} ms), eager "
            f"predict_complex {times[label]['eager_predict_ms']:.3f} ms (medians of {SERVE_RUNS}); "
            f"[{smi}]")
    # Eight concurrent submits (two groups of max_batch=4) against eight
    # sequential predicts, all in the 256x192 bucket.
    eight = [random_raw_complex(200 + i, 175 + i, np.random.default_rng(seed + 10 + i))
             for i in range(8)]
    t0 = time.perf_counter()
    for raw in eight:
        engine.predict(raw)
    sequential_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = [f.result(timeout=120) for f in [engine.submit(raw) for raw in eight]]
    coalesced_s = time.perf_counter() - t0
    log(f"  8 requests at 256x192: sequential predicts {sequential_s * 1e3:.3f} ms "
        f"({8 / sequential_s:.2f} complexes/s), concurrent submits {coalesced_s * 1e3:.3f} ms "
        f"({8 / coalesced_s:.2f} complexes/s; groups {sorted(r['coalesced'] for r in outs)})")
    # Host time of one replay call (copies into the static inputs + launch)
    # and the device time of the graph alone.
    key1, batch1 = _served_batch(engine, [raws[1]])
    entry1 = engine._entries[key1]
    with engine._exec_lock:
        host = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            entry1.replay(batch1.graph1, batch1.graph2)
            host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        graph_ms = time_ms(lambda: entry1.graph.replay(), runs=20)
    replay_host_ms = statistics.median(host)
    log(f"  replay call 256x192 b1: host {replay_host_ms:.4f} ms (copies + one graph "
        f"launch), device {graph_ms:.3f} ms (CUDA events, median of 20)")

    # The warm path captured nothing.
    stats = engine.stats()
    check(stats["capture_count"] == captures,
          f"capture_count {stats['capture_count']} after warm requests, {captures} at warm-up")
    replays = {label: info["replays"] for label, info in stats["compile_inventory"].items()}
    check(sum(replays.values()) >= 20, f"only {sum(replays.values())} replays")
    log(f"  capture_count {captures} after {stats['executed_requests']} served requests; "
        f"replays per key {replays}")
    http = run_http(engine, raws[0])
    log(f"  HTTP: /predict?trace=1 200 {http['trace_phases_ms']}, /healthz, /stats, "
        f"/metrics agree; drain: in-flight completed, POST while draining "
        f"{http['status_while_draining']}")
    del engine
    torch.cuda.empty_cache()
    return {"captures": captures, "capture_s": {k: v["seconds"] for k, v in inventory.items()},
            "per_capture": per_capture,
            "replays": sum(replays.values()), "replays_by_key": replays,
            "profiled_replay": prof, "replay_checks": replay_checks,
            "served_vs_predict_max": max(served_vs_predict), "slot_vs_alone_max": slot_diff,
            "tiled_vs_predict_max": tiled_diff, "times_ms": times,
            "eight_sequential_ms": sequential_s * 1e3, "eight_concurrent_ms": coalesced_s * 1e3,
            "replay_host_ms": replay_host_ms, "replay_device_ms": graph_ms,
            "peak_gib": peak_gib, "reserved_gib": reserved_gib,
            "construct_s": construct_s, "http": http}


# Phase 9's keys of the configurations that capture since the GCN and
# DeepLab forwards stopped reading the host: (bucket_n1, bucket_n2, slots).
SERVE_CONFIG_KEY = (128, 128, 1)


def run_serving_configs(cfg, raws, seed, device) -> dict:
    """Phase 9, continued: an engine with the GCN encoder and one with the
    DeepLab decoder, each with one warm key of 128x128 at one slot. Each
    capture's (K1, K2, CSR builds) is read from the engine: (0, 0, 2) for
    the GCN, (4, 0, 2) for DeepLab. The replay on the served batch against
    the eager forward (bitwise, else 1e-6), the served map against
    ``predict_complex`` (1e-6), and no capture on the warm path."""
    from deepinteract_tpu_torch.serving import EngineConfig, InferenceEngine

    variants = (
        ("gcn", dataclasses.replace(cfg, gnn_layer_type="gcn"), (0, 0, BUILDS_PER_ENCODE_PAIR)),
        ("deeplab", dataclasses.replace(cfg, interact_module_type="deeplab"),
         (LAUNCHES_PER_ENCODE_PAIR, 0, BUILDS_PER_ENCODE_PAIR)))
    out = {}
    for name, variant, want in variants:
        engine = InferenceEngine(variant, cfg=EngineConfig(
            max_batch=1, warmup_buckets=(SERVE_CONFIG_KEY,), result_cache_size=0),
            seed=seed, device=device)
        stats = engine.stats()
        (label, info), = stats["compile_inventory"].items()
        counted = (info["k1_launches"], info["k2_launches"], info["csr_builds"])
        check(stats["capture_count"] == 1 and counted == want,
              f"{name} key {label}: {stats['capture_count']} captures, (K1, K2, CSR builds) "
              f"{counted}, expected 1 and {want}")
        got = engine.predict(raws[0])
        ref = predict_complex(raws[0], engine.model, device)["contact_prob_map"]
        diff = float(np.abs(got["probs"] - ref).max())
        check(got["bucket"] == SERVE_CONFIG_KEY[:2] and diff <= 1e-6,
              f"{name} served {COMPLEXES[0]} vs predict_complex: {diff:.3g} (bar 1e-6)")
        replay = check_replays(engine, None, dict([_served_batch(engine, [raws[0]])]), device)
        check(engine.stats()["capture_count"] == 1, f"{name}: the warm path captured")
        log(f"  {name} key {label}: capture {info['seconds']:.3f} s, (K1, K2, CSR builds) "
            f"{counted}; served vs predict_complex {diff:.3g} (bar 1e-6)")
        out[name] = {"label": label, "capture_s": info["seconds"], "per_capture": counted,
                     "served_vs_predict_max": diff, "replay_check": replay[label]}
        engine.close()
        del engine
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 10: the split phase (screening, index, assembly, calibration)
# ---------------------------------------------------------------------------

SCREEN_LIBRARY = (16, 40, 250)  # chains, shortest, longest: buckets 64..256
# The library's seed is the script's plus this: its 16 lengths fall in all
# four buckets (seed 0's miss 64).
SCREEN_SEED_OFFSET = 1
SCREEN_BATCH = 4  # --screen_batch: chains per encode, pairs per decode
SCREEN_PREEMPT_AT = 5  # decode batches before the guard is requested
SCREEN_NAIVE_PAIRS = 16  # pairs also timed through engine.predict
SCREEN_TIME_RUNS = 2  # CUDA-event repeats per split-phase graph (5, 3 before the front end)
ENCODE_COUNTS = (2, 0, 1)  # (K1, K2, CSR builds) per encode capture: 2 GT layers, 1 CSR
# An item decoded in a batch (or from embeddings encoded in one) against the
# same item alone: phase 9's bar for a slot of a coalesced batch.
SLOT_BAR = 1e-5


def _check_contract(kind: str, text: str) -> dict:
    """The last stdout line of a CLI through tools/check_cli_contract.py."""
    proc = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                                      "check_cli_contract.py"), kind, "-"],
        input=text, capture_output=True, text=True, timeout=60)
    check(proc.returncode == 0, f"{kind} contract refused: {proc.stdout} {proc.stderr}")
    return json.loads(text.strip().splitlines()[-1])


def _run_cli(main_fn, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    check(rc == 0, f"{main_fn.__module__} {argv} exited {rc}: {buf.getvalue()[-500:]}")
    return buf.getvalue()


def _graph_ms(entry, runs: int = SCREEN_TIME_RUNS) -> float:
    """Device time of one replay of an entry's graph (CUDA events)."""
    return time_ms(lambda: entry.graph.replay(), runs=runs)


def check_split_pairs(engine, runner, plain_model, library, records, device) -> dict:
    """One pair per bucket pair of the screen, against the monolithic
    forward's replay at one slot of the same oriented pair: encoded and
    decoded at one slot as well (equal slots: bitwise, else 1e-6), and
    decoded at one slot from the screen's embeddings, which were encoded in
    batches of up to ``SCREEN_BATCH`` (SLOT_BAR); the one-slot split against
    the plain attention's forward (rtol 1e-4, atol 1e-4), and the pair's
    screen score against the score of that map (SLOT_BAR: the screen
    decoded it in a batch)."""
    from deepinteract_tpu_torch.data.graph import stack_graphs
    from deepinteract_tpu_torch.screening import pair_summary
    from deepinteract_tpu_torch.serving.graphs import serve_forward

    def decode(f1, f2, b1, b2, n1, n2):
        args = (f1[None], f2[None], (np.arange(b1) < n1)[None], (np.arange(b2) < n2)[None])
        return engine.replay_to_host(engine.decode_executable(b1, b2, 1, args), *args)[0]

    def encode_alone(cid, bucket):
        entry = library[cid]
        graph = stack_graphs([runner._padded_graph(entry, bucket)])
        encode = engine.encode_executable(bucket, runner._chain_sig(entry.raw), 1, graph)
        return engine.replay_to_host(encode, graph)[0]

    first = {}
    for rec in sorted(records, key=lambda r: r["pair_id"]):
        first.setdefault(tuple(rec["bucket"]), rec)
    out = {}
    for (b1, b2), rec in sorted(first.items()):
        c1, c2, n1, n2 = rec["chain1"], rec["chain2"], rec["n1"], rec["n2"]
        alone = decode(encode_alone(c1, b1), encode_alone(c2, b2), b1, b2, n1, n2)
        emb = runner.ensure_embeddings(library, [c1, c2])[0]
        screened = decode(emb[c1][0], emb[c2][0], b1, b2, n1, n2)
        raw = {"graph1": library[c1].raw, "graph2": library[c2].raw,
               "examples": np.zeros((0, 3), np.int32)}
        key, batch = _served_batch(engine, [raw])
        check(key[:2] == (b1, b2), f"pair {rec['pair_id']}: monolithic key {key[:2]}")
        with engine._exec_lock:
            mono = engine._entry(key, (batch.graph1, batch.graph2)).replay(
                batch.graph1, batch.graph2).cpu().numpy()[0]
            with torch.inference_mode():
                plain = serve_forward(plain_model, batch.graph1.to(device),
                                      batch.graph2.to(device)).cpu().numpy()[0]
        bitwise = bool(np.array_equal(alone, mono))
        diff = float(np.abs(alone - mono).max())
        screened_diff = float(np.abs(screened - mono).max())
        plain_diff = float(np.abs(alone - plain).max())
        score_diff = abs(pair_summary(screened[:n1, :n2], 10)["score"] - rec["score"])
        check(bitwise or diff <= 1e-6,
              f"split {b1}x{b2} at one slot vs monolithic replay: {diff:.3g} (bitwise or "
              "<= 1e-6)")
        check(screened_diff <= SLOT_BAR,
              f"split {b1}x{b2} from the screen's embeddings vs monolithic replay: "
              f"{screened_diff:.3g} (bar {SLOT_BAR})")
        check(bool(np.allclose(alone, plain, rtol=1e-4, atol=1e-4)),
              f"split {b1}x{b2} vs the plain attention: {plain_diff:.3g} (rtol/atol 1e-4)")
        check(score_diff <= SLOT_BAR, f"split {b1}x{b2} score vs the screen's: {score_diff:.3g}")
        out[f"{b1}x{b2}"] = {"pair_id": rec["pair_id"], "bitwise_vs_monolithic": bitwise,
                             "max_abs_diff_vs_monolithic": diff,
                             "screen_embeddings_max_abs_diff_vs_monolithic": screened_diff,
                             "max_abs_diff_vs_plain": plain_diff, "score_diff": score_diff}
        log(f"  split {b1}x{b2} ({rec['pair_id']}): at one slot vs monolithic replay "
            f"{'bitwise equal' if bitwise else f'{diff:.3g}'}; from the screen's embeddings "
            f"{screened_diff:.3g}; vs plain {plain_diff:.3g}; score vs the screen's "
            f"{score_diff:.3g}")
    return out


def run_split_phase_clis(seed, work, smi) -> dict:
    """Each split-phase CLI at the flagship width on the card, its last line
    through tools/check_cli_contract.py: screen, index build and verify,
    query, assemble, calibrate (ECE lower after the fit), and predict
    --top_k --calibration with the fitted artifact."""
    from deepinteract_tpu_torch.cli import assemble, calibrate, index, query, screen

    lib = ["--synthetic_len", "40,60", "--screen_batch", str(SCREEN_BATCH), "--seed", str(seed)]
    out = {}
    rec = _check_contract("screen", _run_cli(screen.main, [
        "--synthetic_chains", "6", *lib, "--out", os.path.join(work, "screen")]))
    check(rec["pairs_scored"] == 15 and rec["encode_reuse_ratio"] == 5.0, f"screen {rec}")
    out["screen"] = rec["value"]
    idx = os.path.join(work, "cli_index")
    rec = _check_contract("index", _run_cli(index.main, [
        "build", "--synthetic_chains", "6", *lib, "--index_dir", idx, "--partition_size", "4"]))
    check(rec["ok"] and rec["encodes_executed"] == 6, f"index build {rec}")
    rec = _check_contract("index", _run_cli(index.main, ["verify", "--index_dir", idx]))
    check(rec["ok"] and rec["corrupt"] == 0 and rec["chains"] == 6, f"index verify {rec}")
    rec = _check_contract("query", _run_cli(query.main, [
        *lib, "--index_dir", idx, "--query", "syn0001", "--top_m", "3",
        "--out", os.path.join(work, "query")]))
    check(rec["pairs_decoded"] == 3 and rec["candidates"] == 5, f"query {rec}")
    out["query_ms"] = rec["value"]
    rec = _check_contract("assemble", _run_cli(assemble.main, [
        "--synthetic_chains", "4", *lib, "--out", os.path.join(work, "assembly")]))
    check(rec["unique_encodes"] == 4 and rec["pairs_scored"] == 6
          and rec["control_score"] is not None, f"assemble {rec}")
    cal_path = os.path.join(work, "calibration.json")
    rec = _check_contract("calibrate", _run_cli(calibrate.main, [
        "--synthetic_chains", "8", *lib, "--calibration_out", cal_path]))
    check(rec["improved"] and rec["ece_calibrated"] < rec["ece_raw"], f"calibrate {rec}")
    out["calibrate"] = {k: rec[k] for k in ("temperature", "ece_raw", "ece_calibrated", "pairs")}
    raw = random_raw_complex(100, 80, np.random.default_rng(seed))
    npz = os.path.join(work, "complex.npz")
    save_complex_npz(npz, raw["graph1"], raw["graph2"], raw["examples"], "smoke")
    rec = _check_contract("predict_topk", _run_cli(predict_cli.main, [
        "--input_npz", npz, "--output_dir", os.path.join(work, "predict"), "--top_k", "10",
        "--calibration", cal_path, "--seed", str(seed)]))
    check(rec["top_k"] == 10 and "calibrated_score" in rec, f"predict --top_k {rec}")
    log(f"  CLIs: screen, index build, index verify, query, assemble, calibrate (ECE "
        f"{out['calibrate']['ece_raw']:.4f} -> {out['calibrate']['ece_calibrated']:.4f}, "
        f"T {out['calibrate']['temperature']:.3f}), predict --top_k --calibration: every "
        "last line accepted by tools/check_cli_contract.py")
    return out


def run_screening(cfg, seed, device, smi, work) -> dict:
    """Phase 10: the split phase at the flagship width on the card. Its
    index is left in ``work/index`` for phase 11's indexed screen."""
    from deepinteract_tpu_torch.assembly import AssemblyConfig, AssemblyRunner
    from deepinteract_tpu_torch.index import (ChainIndex, IndexedQueryRunner, QueryConfig,
                                              build_index, verify_index)
    from deepinteract_tpu_torch.robustness.preemption import PreemptionGuard
    from deepinteract_tpu_torch.screening import (ChainLibrary, EmbeddingCache, ScreenConfig,
                                                  ScreenManifest, ScreenRunner, enumerate_pairs)
    from deepinteract_tpu_torch.screening.library import ChainEntry
    from deepinteract_tpu_torch.serving import EngineConfig, InferenceEngine
    from deepinteract_tpu_torch.serving.graphs import WARMUP_RUNS

    log("== phase 10: split phase (screening, index, assembly, calibration; encode and "
        "decode CUDA graphs, flagship width)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n_chains, lo, hi = SCREEN_LIBRARY
    library = ChainLibrary.synthetic(n_chains, lo, hi, seed=seed + SCREEN_SEED_OFFSET)
    pairs = enumerate_pairs(library)
    check(len(pairs) == n_chains * (n_chains - 1) // 2, f"{len(pairs)} pairs")
    engine = InferenceEngine(cfg, cfg=EngineConfig(max_batch=SCREEN_BATCH, result_cache_size=0),
                             seed=seed, device=device)
    buckets = sorted({engine.chain_bucket(c.n) for c in library.chains})
    check(buckets == list(constants.CHAIN_LENGTH_BUCKETS), f"library buckets {buckets}")
    cache = EmbeddingCache()
    screen_cfg = ScreenConfig(top_k=10, decode_batch=SCREEN_BATCH, encode_batch=SCREEN_BATCH)
    runner = ScreenRunner(engine, cache=cache, cfg=screen_cfg)

    # The main path: counts set to 0 just before the screen, read just after.
    reset_launches()
    t0 = time.perf_counter()
    cold = runner.screen(library, pairs)
    cold_s = time.perf_counter() - t0
    counts = launches()
    stats = engine.stats()
    inventory = stats["compile_inventory"]
    per_key = {label: (i["k1_launches"], i["k2_launches"], i["csr_builds"])
               for label, i in inventory.items()}
    enc = sorted(label for label in inventory if label.startswith("enc:"))
    dec = sorted(label for label in inventory if label.startswith("dec:"))
    check(len(enc) + len(dec) == stats["capture_count"] == len(inventory),
          f"inventory {sorted(inventory)}")
    check(all(per_key[label] == ENCODE_COUNTS for label in enc),
          f"encode captures counted {[per_key[l] for l in enc]}, expected {ENCODE_COUNTS}")
    check(all(per_key[label] == (0, 0, 0) for label in dec),
          f"decode captures counted {[per_key[l] for l in dec]}")
    # The counters run at the warm-up runs before each capture and at the
    # capture, never at a replay.
    runs = (1 + WARMUP_RUNS) * len(enc)
    check(counts == (ENCODE_COUNTS[0] * runs, 0, ENCODE_COUNTS[2] * runs),
          f"screen launches {counts} for {len(enc)} encode captures of {WARMUP_RUNS} warm-up "
          "runs each")
    check(cold.encodes_executed == n_chains and cold.pairs_scored == len(pairs)
          and not cold.preempted, f"cold screen {cold.summary()}")
    enc_replays = sum(inventory[label]["replays"] for label in enc)
    captures = stats["capture_count"]
    log(f"  {n_chains} chains (buckets {buckets}), {len(pairs)} pairs: {cold.encodes_executed} "
        f"encodes in {cold.encode_batches} batches, {cold.decode_batches} decode batches; "
        f"{len(enc)} encode captures, each (K1, K2, CSR builds) {ENCODE_COUNTS}; {len(dec)} "
        f"decode captures; screen launches {counts}; {cold_s:.3f} s cold")

    before = {label: i["replays"] for label, i in engine.stats()["compile_inventory"].items()}
    t0 = time.perf_counter()
    warm = runner.screen(library, pairs)
    warm_s = time.perf_counter() - t0
    warm_replays = {label: i["replays"] - before[label]
                    for label, i in engine.stats()["compile_inventory"].items()}
    check(warm.encodes_executed == 0 and warm.encode_cache_hits == n_chains
          and engine.capture_count == captures,
          f"warm repeat: {warm.encodes_executed} encodes, {warm.encode_cache_hits} hits, "
          f"{engine.capture_count - captures} captures")
    check([(r["pair_id"], r["score"]) for r in warm.records]
          == [(r["pair_id"], r["score"]) for r in cold.records],
          "the warm repeat's records differ from the cold screen's")
    log(f"  warm repeat: 0 encodes, {warm.encode_cache_hits} cache hits, 0 captures, records "
        f"equal; {warm_s:.3f} s")

    enc_key = next(k for k in engine._entries if k[0] == "enc")
    prof = profile_graph(engine, engine._entries[enc_key])
    check(prof["k1"] == ENCODE_COUNTS[0],
          f"profiled encode replay: {prof['k1']} K1 kernels of {prof['kernels']}")
    log(f"  profiled encode replay {engine._key_label(enc_key)}: {prof['k1']} K1 kernels among "
        f"{prof['kernels']} device kernels")

    plain_model = load_model(plain_variant(cfg), device, seed=seed)
    plain_model.load_state_dict(engine.model.state_dict())
    split_checks = check_split_pairs(engine, runner, plain_model, library, cold.records, device)
    del plain_model

    # A manifest-backed screen preempted by its guard, then resumed.
    path = os.path.join(work, "manifest.json")
    m1, _ = ScreenManifest.load_or_create(path, library.signature(), len(pairs))
    guard = PreemptionGuard(log=lambda msg: None)
    r1 = ScreenRunner(engine, cache=cache, cfg=screen_cfg).screen(
        library, pairs, manifest=m1, guard=guard,
        after_batch=lambda n: guard.request("smoke") if n == SCREEN_PREEMPT_AT else None)
    m2, resumed = ScreenManifest.load_or_create(path, library.signature(), len(pairs))
    r2 = ScreenRunner(engine, cache=cache, cfg=screen_cfg).screen(
        library, pairs, manifest=m2, guard=PreemptionGuard(log=lambda msg: None))
    check(r1.preempted and resumed and r1.decode_batches == SCREEN_PREEMPT_AT
          and 0 < r1.pairs_scored < len(pairs)
          and r1.pairs_scored + r2.pairs_scored == len(pairs)
          and r2.pairs_resumed == r1.pairs_scored and not r2.preempted,
          f"preempted {r1.summary()} resumed {r2.summary()}")
    ref = {r["pair_id"]: r for r in cold.records}
    resume_diff, resume_bitwise = 0.0, 0
    check({r["pair_id"] for r in r2.records} == set(ref), "the resumed records' pairs")
    for rec in r2.records:
        want = ref[rec["pair_id"]]
        check((rec["chain1"], rec["chain2"], rec["bucket"]) == (
            want["chain1"], want["chain2"], want["bucket"]), f"orientation {rec['pair_id']}")
        resume_diff = max(resume_diff, abs(rec["score"] - want["score"]))
        resume_bitwise += rec["score"] == want["score"]
    check(resume_diff <= SLOT_BAR, f"resumed scores vs uninterrupted: {resume_diff:.3g}")
    log(f"  preempted after {r1.pairs_scored} pairs, resumed: {r2.pairs_scored} more, "
        f"{r2.pairs_resumed} from the manifest; scores vs the uninterrupted screen "
        f"{resume_bitwise}/{len(pairs)} bitwise, max |diff| {resume_diff:.3g} (bar "
        f"{SLOT_BAR})")

    # An index over the library (the screen's cached embeddings), and
    # queries of two chains whose scores are the screen's rows.
    index_dir = os.path.join(work, "index")
    built = build_index(engine, library, index_dir, partition_size=8,
                        encode_batch=SCREEN_BATCH, cache=cache)
    report = verify_index(index_dir)
    check(report["ok"] and report["chains"] == n_chains and not built.preempted,
          f"index verify {report}")
    index = ChainIndex.open(index_dir)
    qrunner = IndexedQueryRunner(engine, index, cfg=QueryConfig(
        top_m=8, top_k=10, decode_batch=SCREEN_BATCH))
    query_diff = 0.0
    t0 = time.perf_counter()
    for q in library.ids()[:2]:
        res = qrunner.query_from_index(q)
        check(res.survivors == res.pairs_decoded == 8 and res.candidates == n_chains - 1,
              f"query {q}: {res.summary()}")
        for rec in res.records:
            want = ref[rec["pair_id"]]
            check((rec["chain1"], rec["chain2"]) == (want["chain1"], want["chain2"]),
                  f"query orientation {rec['pair_id']}")
            query_diff = max(query_diff, abs(rec["score"] - want["score"]))
    query_s = (time.perf_counter() - t0) / 2
    check(query_diff <= SLOT_BAR, f"query scores vs the screen's rows: {query_diff:.3g}")
    log(f"  index: {built.partitions_total} partitions, verify ok; 2 queries (top_m 8) of "
        f"{index.num_chains - 1} candidates, scores vs the screen's rows max |diff| "
        f"{query_diff:.3g} (bar {SLOT_BAR}), {query_s * 1e3:.3f} ms each")

    # A 4-chain assembly with one chain twice (under a second id).
    a, b, c = library.chains[:3]
    asm_lib = ChainLibrary([a, b, c, ChainEntry(f"{a.chain_id}_twin", a.raw, a.n)])
    assembly = AssemblyRunner(engine, cache=EmbeddingCache(), cfg=AssemblyConfig(
        decode_batch=SCREEN_BATCH, encode_batch=SCREEN_BATCH)).assemble(asm_lib)
    check(assembly.unique_encodes == 3 and assembly.pairs_scored == 6
          and assembly.control_score is not None, f"assembly {assembly.summary()}")
    log(f"  assembly of 4 chains (one twice): {assembly.unique_encodes} encodes, "
        f"{assembly.pairs_scored} pairs, interactability {assembly.interactability:.6f}, "
        f"control {assembly.control_score:.6f}")
    clis = run_split_phase_clis(seed, work, smi)

    # Times: each graph's replay (device, CUDA events) per chain and per
    # pair; the screen's pairs per second; the same pairs through predict.
    encode_ms, decode_ms, replay_ms = {}, {}, {}
    for key, entry in sorted(engine._entries.items(), key=lambda kv: str(kv[0])):
        if key[0] in ("enc", "dec"):
            label = engine._key_label(key)
            replay_ms[label] = _graph_ms(entry)
            (encode_ms if key[0] == "enc" else decode_ms)[label] = replay_ms[label] / key[3]
    # The warm screen's device time: its replays of each key times the
    # key's replay time (it encodes nothing).
    warm_device_s = sum(n * replay_ms[label] for label, n in warm_replays.items() if n) / 1e3
    naive = pairs[::len(pairs) // SCREEN_NAIVE_PAIRS][:SCREEN_NAIVE_PAIRS]
    naive_raws = [{"graph1": library[c1].raw, "graph2": library[c2].raw,
                   "examples": np.zeros((0, 3), np.int32)} for c1, c2 in naive]
    for raw in naive_raws:  # warm every key first: captures are not timed
        engine.predict(raw)
    t0 = time.perf_counter()
    for raw in naive_raws:
        engine.predict(raw)
    naive_s = time.perf_counter() - t0
    times = {"encode_ms_per_chain": encode_ms, "decode_ms_per_pair": decode_ms,
             "screen_cold_s": cold_s, "screen_warm_s": warm_s,
             "screen_warm_device_s": warm_device_s,
             "screen_warm_device_share": warm_device_s / warm_s,
             "screen_cold_pairs_per_s": len(pairs) / cold_s,
             "screen_warm_pairs_per_s": len(pairs) / warm_s,
             "predict_pairs": len(naive), "predict_s": naive_s,
             "predict_pairs_per_s": len(naive) / naive_s,
             "query_ms": query_s * 1e3,
             "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    for label, ms in encode_ms.items():
        log(f"  encode {label}: {ms:.3f} ms per chain (replay device time / slots)")
    for label, ms in decode_ms.items():
        log(f"  decode {label}: {ms:.3f} ms per pair (replay device time / slots)")
    log(f"  screen of {len(pairs)} pairs: cold {cold_s:.3f} s ({len(pairs) / cold_s:.2f} pairs/s, "
        f"captures included), warm {warm_s:.3f} s ({len(pairs) / warm_s:.2f} pairs/s, of which "
        f"replay device time {warm_device_s:.3f} s); "
        f"{len(naive)} of its pairs through engine.predict (warm) {naive_s:.3f} s "
        f"({len(naive) / naive_s:.2f} pairs/s); peak {times['peak_gib']:.3f} GiB; [{smi}]")
    engine.close()
    del engine, runner, cache
    torch.cuda.empty_cache()
    return {"chains": n_chains, "pairs": len(pairs), "buckets": buckets,
            "launches": counts, "encode_captures": len(enc), "decode_captures": len(dec),
            "per_encode_capture": ENCODE_COUNTS, "encode_replays": enc_replays,
            "captures": captures, "encodes": cold.encodes_executed,
            "warm_cache_hits": warm.encode_cache_hits, "profiled_encode_replay": prof,
            "split_checks": split_checks, "resume_max_diff": resume_diff,
            "resume_bitwise": resume_bitwise, "query_max_diff": query_diff,
            "assembly": assembly.summary(), "clis": clis, "times": times}


# ---------------------------------------------------------------------------
# Phase 11: the split-phase routes and the serving fleet
# ---------------------------------------------------------------------------

FLEET_WARMUP = "128x128x1,256x192x1"  # the engine workers' warm-up keys
FLEET_COUNTS = (4, 0, 2)  # (K1, K2, CSR builds) per flagship capture in a worker
FLEET_LOAD_THREADS = 16  # concurrent /predict clients under the SIGKILL
ROLLOVER_LOAD_THREADS = 8  # and under the rollover
FLEET_TIME_RUNS = 3  # routed and direct requests per bucket (10, 5 before the front end)
# --fleet_warm_timeout_s: the aborted rollover waits it out. A rollover of
# two flagship workers under 16 clients took 24.3 s (PR 9's first run).
FLEET_WARM_TIMEOUT_S = 32.0
FLEET_START_TIMEOUT_S = 240.0
ROUTE_LIBRARY = ((60, 90), (110, 70), (40, 120), (100, 50))  # 8 chains, buckets 64 and 128
ROUTE_ASSEMBLY = ((180, 220), (230, 170))  # new chains (bucket 256): the assembly captures
ROUTE_FRESH = 6  # fresh complexes (12 chains) for the 1 ms deadline
ABSENT_SIGNATURE = "jax-variables:0000000000000000"  # no replacement reaches it


def random_weights_npz(cfg, seed: int, path: str) -> None:
    """A ``.npz`` of JAX variables for ``cfg`` made from ``seed``
    (fan-in-scaled normal kernels, positive running variances): the file an
    engine worker loads with ``--weights``."""
    from deepinteract_tpu_torch.models.model import DeepInteract
    from deepinteract_tpu_torch.weights import jax_variable_shapes, save_npz

    rng = np.random.default_rng(seed)

    def fill(node, path):
        out = {}
        for key, value in node.items():
            if isinstance(value, dict):
                out[key] = fill(value, path + (key,))
                continue
            arr = rng.standard_normal(value).astype(np.float32)
            if len(value) >= 2:
                fan = value[1:-1] if "chunks" in path else value[:-1]
                arr /= np.sqrt(max(int(np.prod(fan)), 1))
            if key == "var":
                arr = np.abs(arr) + 0.5
            out[key] = arr
        return out

    save_npz(path, fill(jax_variable_shapes(DeepInteract(cfg)), ()))


def _write_complexes(work, prefix, sizes, seed) -> list:
    paths = []
    for i, (n1, n2) in enumerate(sizes):
        raw = random_raw_complex(n1, n2, np.random.default_rng(seed + i))
        paths.append(os.path.join(work, f"{prefix}{i}.npz"))
        save_complex_npz(paths[-1], raw["graph1"], raw["graph2"], raw["examples"],
                         f"{prefix}{i}")
    return paths


def _post_json(host, port, path, payload, headers=None, timeout=300):
    return _post(host, port, path, json.dumps(payload).encode(),
                 {"Content-Type": "application/json", **(headers or {})}, timeout=timeout)


def _same(got, want) -> tuple:
    """(bitwise, max |diff|) of two arrays; the check is bitwise, else 1e-6."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return False, math.inf
    diff = float(np.abs(got - want).max()) if got.size else 0.0
    return bool(np.array_equal(got, want)), diff


def _check_records(label, got, want) -> dict:
    """Ranked records: the same pairs in the same order, scores bitwise
    (else within 1e-6)."""
    check([r["pair_id"] for r in got] == [r["pair_id"] for r in want],
          f"{label}: ranked pairs differ")
    bitwise, diff = _same([r["score"] for r in got], [r["score"] for r in want])
    check(bitwise or diff <= 1e-6, f"{label}: scores differ by {diff:.3g} (bar 1e-6)")
    return {"pairs": len(got), "bitwise": bitwise, "max_abs_diff": diff}


def _encode_captures(engine) -> dict:
    return {label: (i["k1_launches"], i["k2_launches"], i["csr_builds"])
            for label, i in engine.stats()["compile_inventory"].items()
            if label.startswith("enc:")}


def run_routes(cfg, seed, device, work) -> dict:
    """Phase 11a: ``POST /screen``, ``POST /assembly`` and the indexed
    ``/screen`` of ``ServingServer`` in process, at the flagship width."""
    from deepinteract_tpu_torch.cli import query as query_cli
    from deepinteract_tpu_torch.index import ChainIndex
    from deepinteract_tpu_torch.screening import (ChainLibrary, ScreenConfig, ScreenRunner,
                                                  enumerate_pairs)
    from deepinteract_tpu_torch.serving import EngineConfig, InferenceEngine, ServingServer
    from deepinteract_tpu_torch.serving.graphs import WARMUP_RUNS

    log("  11a: the split-phase routes in process (ServingServer, seeded flagship engine)")
    engine = InferenceEngine(cfg, cfg=EngineConfig(max_batch=SCREEN_BATCH, result_cache_size=0),
                             seed=seed, device=device)
    files = _write_complexes(work, "route", ROUTE_LIBRARY, seed + 111)
    library = ChainLibrary.from_complex_files(files)
    pairs = enumerate_pairs(library)
    check(len(library) == 8 and len(pairs) == 28, f"route library {len(library)} chains")
    index_dir = os.path.join(work, "index")  # phase 10's index, built by the same seed
    server = ServingServer(engine, port=0, screen_max_pairs=len(pairs), index_path=index_dir)
    server.serve_background()
    host, port = server.address
    out = {}
    try:
        reset_launches()
        t0 = time.perf_counter()
        status, screen = _post_json(host, port, "/screen", {"npz_paths": files, "top_k": 10})
        screen_s = time.perf_counter() - t0
        counts = launches()
        check(status == 200 and screen["pairs"] == 28 and screen["encodes_executed"] == 8,
              f"/screen {status}: {str(screen)[:300]}")
        per_capture = _encode_captures(engine)
        check(per_capture and all(c == ENCODE_COUNTS for c in per_capture.values()),
              f"/screen encode captures counted {per_capture}, expected {ENCODE_COUNTS}")
        runs = (1 + WARMUP_RUNS) * len(per_capture)
        check(counts == (ENCODE_COUNTS[0] * runs, 0, ENCODE_COUNTS[2] * runs),
              f"/screen launches {counts} for {len(per_capture)} encode captures")
        runner = ScreenRunner(engine, cache=server._screen_cache, cfg=ScreenConfig(
            top_k=10, decode_batch=SCREEN_BATCH, encode_batch=SCREEN_BATCH))
        direct = runner.screen(library, pairs)
        out["screen_vs_runner"] = _check_records("/screen vs ScreenRunner.screen",
                                                 screen["ranked"], direct.records)
        out["screen"] = {"launches": counts, "encode_captures": len(per_capture),
                         "per_encode_capture": ENCODE_COUNTS, "seconds": screen_s}
        log(f"  /screen of 8 chains: 28 pairs, 8 encodes, {len(per_capture)} encode captures "
            f"each (K1, K2, CSR builds) {ENCODE_COUNTS}, launches {counts}; records vs "
            f"ScreenRunner.screen on the same engine and cache: "
            f"{'bitwise equal' if out['screen_vs_runner']['bitwise'] else out['screen_vs_runner']['max_abs_diff']}"
            f"; {screen_s:.3f} s")

        # A 4-chain assembly, one chain twice (under a second id), in a new bucket.
        raw_a = random_raw_complex(*ROUTE_ASSEMBLY[0], np.random.default_rng(seed + 121))
        raw_b = random_raw_complex(*ROUTE_ASSEMBLY[1], np.random.default_rng(seed + 122))
        asm_files = [os.path.join(work, "asm0.npz"), os.path.join(work, "asm1.npz")]
        none = np.zeros((0, 3), np.int32)
        save_complex_npz(asm_files[0], raw_a["graph1"], raw_a["graph2"], none, "asm0")
        save_complex_npz(asm_files[1], raw_b["graph1"], raw_a["graph1"], none, "asm1")
        before = set(_encode_captures(engine))
        reset_launches()
        status, asm = _post_json(host, port, "/assembly", {"npz_paths": asm_files, "top_k": 10})
        asm_counts = launches()
        new = {k: v for k, v in _encode_captures(engine).items() if k not in before}
        check(status == 200 and asm["unique_encodes"] == 3 and asm["pairs_scored"] == 6
              and asm["control_score"] is not None, f"/assembly {status}: {str(asm)[:300]}")
        runs = (1 + WARMUP_RUNS) * len(new)
        check(new and asm_counts == (ENCODE_COUNTS[0] * runs, 0, ENCODE_COUNTS[2] * runs),
              f"/assembly launches {asm_counts} for new encode captures {new}")
        out["assembly"] = {"unique_encodes": asm["unique_encodes"], "launches": asm_counts,
                           "encode_captures": len(new)}
        log(f"  /assembly of 4 chains (one twice): {asm['unique_encodes']} encodes, 6 pairs, "
            f"{len(new)} new encode captures, launches {asm_counts}")

        # The indexed screen against phase 10's index, and cli.query on it.
        query = ChainIndex.open(index_dir).chain_ids()[0]
        status, indexed = _post_json(host, port, "/screen",
                                     {"indexed": True, "query": query, "top_m": 8, "top_k": 10})
        check(status == 200 and indexed["indexed"] and not indexed["partial"]
              and indexed["pairs_decoded"] == 8, f"indexed /screen {status}: {str(indexed)[:300]}")
        rec = _check_contract("query", _run_cli(query_cli.main, [
            "--index_dir", index_dir, "--query", query, "--top_m", "8", "--top_k", "10",
            "--screen_batch", str(SCREEN_BATCH), "--seed", str(seed),
            "--out", os.path.join(work, "route_query")]))
        with open(rec["ranked_out"]) as fh:
            cli_rows = [json.loads(line) for line in fh if line.strip()]
        out["indexed_vs_cli_query"] = _check_records("indexed /screen vs cli.query",
                                                     indexed["ranked"], cli_rows)
        log(f"  indexed /screen of {query} (top_m 8) against phase 10's index: the same 8 "
            "partners as cli.query, scores "
            f"{'bitwise equal' if out['indexed_vs_cli_query']['bitwise'] else out['indexed_vs_cli_query']['max_abs_diff']}")

        # Refusals: over screen_max_pairs (400), a 1 ms deadline (504).
        extra = _write_complexes(work, "extra", ((70, 80),), seed + 131)
        status, body = _post_json(host, port, "/screen", {"npz_paths": files + extra})
        check(status == 400 and "synchronous limit" in body["error"],
              f"oversize /screen: {status} {body}")
        fresh = _write_complexes(work, "fresh", [(90, 110)] * ROUTE_FRESH, seed + 141)
        first = ChainLibrary.from_complex_files(fresh[:1]).ids()[0]
        status, body = _post_json(host, port, "/screen", {"npz_paths": fresh, "query": [first]},
                                  headers={"X-Request-Deadline-Ms": "1"})
        check(status == 504 and "deadline" in body["error"], f"1 ms deadline: {status} {body}")
        status, stats = _get(host, port, "/stats")
        check(stats["screening"]["requests"] >= 2 and stats["screening"]["requests_rejected"] >= 1,
              f"/stats screening block {stats['screening']}")
        out["refusals"] = {"oversize": 400, "deadline_1ms": 504}
        log("  oversize /screen (45 pairs, limit 28): 400; 1 ms deadline: 504; /stats screening "
            f"block {stats['screening']}")
    finally:
        server.httpd.shutdown()
        server.httpd.server_close()
        engine.close()
    out["route_screen_per_encode_capture"] = ENCODE_COUNTS[0]
    out["route_assembly"] = out["assembly"]["launches"][0]
    return out


def card_used_gib() -> float:
    """Memory in use on the card by every process (driver's count)."""
    free, total = torch.cuda.mem_get_info()
    return (total - free) / 2 ** 30


class _Load:
    """``threads`` clients POSTing /predict through the router in a loop,
    each request's (start, seconds, status, worker) kept."""

    def __init__(self, host, port, bodies, threads):
        self.results, self._lock, self._stop = [], threading.Lock(), threading.Event()
        self._threads = [threading.Thread(target=self._client, args=(host, port, bodies, i),
                                          daemon=True) for i in range(threads)]
        for t in self._threads:
            t.start()

    def _client(self, host, port, bodies, i):
        import http.client

        n = i
        while not self._stop.is_set():
            body = bodies[n % len(bodies)]
            n += 1
            t0 = time.perf_counter()
            try:
                conn = http.client.HTTPConnection(host, port, timeout=120)
                conn.request("POST", "/predict", body=body,
                             headers={"Content-Type": "application/octet-stream"})
                resp = conn.getresponse()
                resp.read()
                status, worker = resp.status, resp.getheader("X-DI-Worker")
                conn.close()
            except Exception as exc:  # noqa: BLE001 - tallied as a failure
                status, worker = -1, repr(exc)
            with self._lock:
                self.results.append((t0, time.perf_counter() - t0, status, worker))

    def count(self) -> int:
        with self._lock:
            return len(self.results)

    def wait_for(self, n, timeout=60.0) -> None:
        t_end = time.monotonic() + timeout
        while self.count() < n and time.monotonic() < t_end:
            time.sleep(0.01)
        check(self.count() >= n, f"load reached {self.count()} of {n} requests")

    def stop(self) -> list:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=150)
        check(not any(t.is_alive() for t in self._threads), "a load client hung")
        return list(self.results)


def _percentiles(seconds) -> dict:
    ms = sorted(1e3 * s for s in seconds)
    if not ms:
        return {"n": 0}
    return {"n": len(ms), "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99))}


def _fleet_stats(host, port) -> dict:
    status, stats = _get(host, port, "/stats", timeout=60)
    check(status == 200, f"router /stats {status}")
    return stats


def _wait_fleet(host, port, want_ids, keys, timeout, since) -> dict:
    """Poll the router until every worker in ``want_ids`` is healthy with
    ``keys`` warm; returns worker -> seconds from ``since`` to warm."""
    warm_at = {}
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        workers = _fleet_stats(host, port)["fleet"]["workers"]
        for wid in want_ids:
            info = workers.get(wid, {})
            labels = (info.get("health") or {}).get("warm_buckets") or []
            if (wid not in warm_at and info.get("state") == "healthy"
                    and all(any(str(l).startswith(k) for l in labels) for k in keys)):
                warm_at[wid] = time.perf_counter() - since
        if len(warm_at) == len(want_ids):
            return warm_at
        time.sleep(0.1)
    check(False, f"workers {sorted(set(want_ids) - set(warm_at))} not warm after {timeout} s")


def _tail(path, n=40) -> str:
    try:
        with open(path, errors="replace") as fh:
            return "".join(fh.readlines()[-n:])
    except OSError:
        return f"({path} not readable)"


def run_fleet(cfg, seed, device, smi, work, route_files) -> dict:
    """Phase 11b-e: ``cli.serve --workers 2`` with real engine workers on
    the card behind the port's router."""
    from deepinteract_tpu_torch.cli.serve import parse_warmup_spec, warm_bucket_prefixes
    from deepinteract_tpu_torch.screening import (ChainLibrary, EmbeddingCache, ScreenConfig,
                                                  ScreenRunner, enumerate_pairs)
    from deepinteract_tpu_torch.serving import EngineConfig, InferenceEngine

    log("  11b: a fleet of 2 engine workers (cli.serve --workers 2) behind the router")
    weights = [os.path.join(work, f"fleet_weights{i}.npz") for i in (1, 2)]
    for i, path in enumerate(weights):
        random_weights_npz(cfg, seed + 201 + i, path)
    warm = parse_warmup_spec(FLEET_WARMUP)
    keys = warm_bucket_prefixes(FLEET_WARMUP)
    raws = [random_raw_complex(n1, n2, np.random.default_rng(seed + 211 + i))
            for i, (n1, n2) in enumerate(COMPLEXES[:2])]  # buckets 128x128, 256x192
    bodies = [_npz_bytes(raw) for raw in raws]
    refs, want, sigs = [], [], []
    for path in weights:
        ref = InferenceEngine(cfg, cfg=EngineConfig(warmup_buckets=warm, result_cache_size=0),
                              device=device, weights=path)
        refs.append(ref)
        want.append([ref.predict(raw)["probs"] for raw in raws])
        sigs.append(ref.weights_signature())
        check(all(np.isfinite(p).all() for p in want[-1]), f"{path}: probabilities not finite")
    check(sigs[0] != sigs[1] and sigs[0].startswith("jax-variables:"), f"signatures {sigs}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    used_before = card_used_gib()

    fleet_dir = os.path.join(work, "fleet")
    err_path = os.path.join(work, "fleet_router.log")
    err = open(err_path, "w")
    t_start = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "deepinteract_tpu_torch.cli.serve", "--workers", "2",
         "--warmup_buckets", FLEET_WARMUP, "--weights", weights[0], "--port", "0",
         "--fleet_dir", fleet_dir, "--probe_interval_s", "0.25", "--result_cache_size", "0",
         "--fleet_warm_timeout_s", str(FLEET_WARM_TIMEOUT_S), "--device", device.type],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE, stderr=err,
        text=True)
    out = {}
    try:
        line = proc.stdout.readline()
        match = re.match(r"fleet router on http://([\d.]+):(\d+)", line)
        check(match is not None, f"fleet did not start: {line!r}")
        host, port = match.group(1), int(match.group(2))
        start_to_warm = _wait_fleet(host, port, ("w1", "w2"), keys, FLEET_START_TIMEOUT_S,
                                    t_start)
        used_2 = card_used_gib()
        stats = _fleet_stats(host, port)
        per_key = {}
        for wid in ("w1", "w2"):
            inventory = stats["workers"][wid]["engine"]["compile_inventory"]
            per_key[wid] = {label: (i["k1_launches"], i["k2_launches"], i["csr_builds"])
                            for label, i in inventory.items()}
            check(len(per_key[wid]) == 2 and all(c == FLEET_COUNTS
                                                 for c in per_key[wid].values()),
                  f"{wid} inventory {per_key[wid]}, expected 2 keys of {FLEET_COUNTS}")
            check(stats["fleet"]["workers"][wid]["health"]["weights_signature"] == sigs[0],
                  f"{wid} serves {stats['fleet']['workers'][wid]['health']}")
        log(f"  2 workers warm (status ok, {list(keys)}); start to warm "
            + ", ".join(f"{w} {s:.3f} s" for w, s in sorted(start_to_warm.items()))
            + f"; each key (K1, K2, CSR builds) {FLEET_COUNTS}: {per_key}; card memory in use "
            f"{used_before:.3f} GiB before, {used_2:.3f} GiB with 2 workers")
        routed = {}
        for raw, body, ref in zip(raws, bodies, want[0]):
            status, res = _post(host, port, "/predict", body,
                                {"Content-Type": "application/octet-stream"})
            check(status == 200, f"routed /predict {status}: {str(res)[:300]}")
            label = "x".join(map(str, res["bucket"]))
            routed[label] = dict(zip(("bitwise", "max_abs_diff"), _same(res["contact_probs"], ref)))
            check(routed[label]["bitwise"] or routed[label]["max_abs_diff"] <= 1e-6,
                  f"routed /predict {label} vs an in-process replay: {routed[label]}")
        library = ChainLibrary.from_complex_files(route_files)
        status, screen = _post_json(host, port, "/screen", {"npz_paths": route_files, "top_k": 10})
        check(status == 200, f"routed /screen {status}: {str(screen)[:300]}")
        direct = ScreenRunner(refs[0], cache=EmbeddingCache(), cfg=ScreenConfig(
            top_k=10, decode_batch=8, encode_batch=8)).screen(library, enumerate_pairs(library))
        routed["screen"] = _check_records("routed /screen vs an in-process ScreenRunner",
                                          screen["ranked"], direct.records)
        log(f"  routed /predict vs in-process replays of the same key: {routed}")

        # 11e (part): routed against direct latency per bucket, medians of FLEET_TIME_RUNS.
        ports = {wid: w["port"] for wid, w in stats["fleet"]["workers"].items()
                 if w["state"] == "healthy"}
        latency = {}
        for raw, body in zip(raws, bodies):
            label = "x".join(map(str, refs[0].bucket_for(raw["graph1"]["node_feats"].shape[0],
                                                         raw["graph2"]["node_feats"].shape[0])))
            times = {"routed": [], "direct": []}
            for _ in range(FLEET_TIME_RUNS):
                for kind, (h, p) in (("routed", (host, port)), ("direct", (host, ports["w1"]))):
                    t0 = time.perf_counter()
                    status, _ = _post(h, p, "/predict", body,
                                      {"Content-Type": "application/octet-stream"})
                    times[kind].append(time.perf_counter() - t0)
                    check(status == 200, f"{kind} /predict {status}")
            latency[label] = {k: 1e3 * statistics.median(v) for k, v in times.items()}
            log(f"  {label}: routed {latency[label]['routed']:.3f} ms, direct (worker w1) "
                f"{latency[label]['direct']:.3f} ms (HTTP round trip, medians of "
                f"{FLEET_TIME_RUNS}) [{smi}]")

        log("  11c: SIGKILL of a worker under 16 concurrent /predict clients")
        load = _Load(host, port, bodies, FLEET_LOAD_THREADS)
        load.wait_for(2 * FLEET_LOAD_THREADS)
        victim = _fleet_stats(host, port)["fleet"]["workers"]["w1"]["pid"]
        os.kill(victim, signal.SIGKILL)
        t_kill = time.perf_counter()
        load.wait_for(load.count() + 4 * FLEET_LOAD_THREADS)
        results = load.stop()
        failed = [r for r in results if r[2] != 200]
        check(not failed, f"{len(failed)} of {len(results)} requests failed across the SIGKILL: "
              f"{failed[:3]}")
        rewarm = _wait_fleet(host, port, ("w1",), keys, FLEET_START_TIMEOUT_S, t_kill)
        info = _fleet_stats(host, port)["fleet"]["workers"]["w1"]
        check(info["restarts"] == 1 and info["pid"] != victim, f"w1 after the kill: {info}")
        answering = set()
        for _ in range(8):
            status, res = _post(host, port, "/predict", bodies[0],
                                {"Content-Type": "application/octet-stream"})
            check(status == 200, f"/predict after the restart {status}")
        for _ in range(8):
            conn = http.client.HTTPConnection(host, port, timeout=120)
            conn.request("POST", "/predict", body=bodies[1],
                         headers={"Content-Type": "application/octet-stream"})
            resp = conn.getresponse()
            resp.read()
            answering.add(resp.getheader("X-DI-Worker"))
            conn.close()
        check(answering == {"w1", "w2"}, f"after the restart X-DI-Worker shows {answering}")
        out["failover"] = {"requests": len(results), "failed": 0,
                           "restart_to_warm_s": rewarm["w1"], "answering": sorted(answering)}
        log(f"  {len(results)} requests across the SIGKILL, 0 failed; w1 restarted and warm "
            f"{rewarm['w1']:.3f} s after the kill; both workers answer afterwards")

        log(f"  11d: rollover to a second weights file under {ROLLOVER_LOAD_THREADS} clients")
        load = _Load(host, port, bodies, ROLLOVER_LOAD_THREADS)
        load.wait_for(4 * ROLLOVER_LOAD_THREADS)
        peak = {"used": card_used_gib()}
        sampling = threading.Event()

        def sample():
            while not sampling.is_set():
                peak["used"] = max(peak["used"], card_used_gib())
                time.sleep(0.2)

        sampler = threading.Thread(target=sample, daemon=True)
        sampler.start()
        old_ids = sorted(w for w, i in _fleet_stats(host, port)["fleet"]["workers"].items()
                         if i["state"] == "healthy")
        t0 = time.perf_counter()
        status, record = _post_json(host, port, "/admin/rollover",
                                    {"weights": weights[1], "weights_signature": sigs[1]},
                                    timeout=FLEET_WARM_TIMEOUT_S + 200)
        t1 = time.perf_counter()
        sampling.set()
        sampler.join(timeout=10)
        load.wait_for(load.count() + 2 * ROLLOVER_LOAD_THREADS)
        results = load.stop()
        check(status == 200 and record.get("rollover", {}).get("ok"),
              f"rollover {status}: {str(record)[:400]}")
        roll = record["rollover"]
        check(sorted(roll["old_workers"]) == old_ids
              and set(roll["drain_exit_codes"].values()) == {0},
              f"old workers' exit codes {roll['drain_exit_codes']}")
        bad = [r for r in results if r[2] >= 500 or r[2] < 0]
        check(not bad, f"{len(bad)} 5xx or failed of {len(results)} during the rollover: {bad[:3]}")
        before = _percentiles([r[1] for r in results if r[0] < t0])
        during = _percentiles([r[1] for r in results if t0 <= r[0] <= t1])
        after = {}
        for raw, body, ref in zip(raws, bodies, want[1]):
            status, res = _post(host, port, "/predict", body,
                                {"Content-Type": "application/octet-stream"})
            check(status == 200, f"/predict after the rollover {status}")
            label = "x".join(map(str, res["bucket"]))
            after[label] = dict(zip(("bitwise", "max_abs_diff"), _same(res["contact_probs"], ref)))
            check(after[label]["bitwise"] or after[label]["max_abs_diff"] <= 1e-6,
                  f"/predict {label} after the rollover vs the new weights: {after[label]}")
        out["rollover"] = {"elapsed_s": roll["elapsed_s"], "requests": len(results),
                           "errors_5xx": 0, "drain_exit_codes": roll["drain_exit_codes"],
                           "latency_before": before, "latency_during": during,
                           "maps_vs_new_weights": after, "card_used_gib_peak": peak["used"]}
        log(f"  rollover {roll['old_workers']} -> {roll['new_workers']} in {roll['elapsed_s']} s, "
            f"old workers exit {roll['drain_exit_codes']}; {len(results)} requests, 0 5xx; "
            f"latency before p50 {before.get('p50_ms', 0):.3f} / p99 {before.get('p99_ms', 0):.3f} "
            f"ms ({before['n']}), during p50 {during.get('p50_ms', 0):.3f} / p99 "
            f"{during.get('p99_ms', 0):.3f} ms ({during['n']}); maps after vs the new weights "
            f"{after}; card memory in use at most {peak['used']:.3f} GiB (4 workers at the "
            f"overlap) [{smi}]")

        t0 = time.perf_counter()
        status, record = _post_json(host, port, "/admin/rollover",
                                    {"weights": weights[0], "weights_signature": ABSENT_SIGNATURE},
                                    timeout=FLEET_WARM_TIMEOUT_S + 200)
        abort_s = time.perf_counter() - t0
        check(status == 500 and record.get("ok") is False and "not warm" in record.get("error", ""),
              f"rollover to an unreachable signature: {status} {str(record)[:300]}")
        for body, ref in zip(bodies, want[1]):
            status, res = _post(host, port, "/predict", body,
                                {"Content-Type": "application/octet-stream"})
            bitwise, diff = _same(res["contact_probs"], ref) if status == 200 else (False, 0)
            check(status == 200 and (bitwise or diff <= 1e-6),
                  f"/predict after the aborted rollover: {status}")
        out["aborted_rollover_s"] = abort_s
        # Coalesced groups under load ask for batch keys beyond the warm-up's
        # b1: each worker's inventory at the end.
        workers = _fleet_stats(host, port)["workers"]
        out["inventory_after_load"] = {
            wid: sorted(w["engine"]["compile_inventory"]) for wid, w in workers.items()
            if isinstance(w, dict) and "engine" in w}
        log(f"  graph inventory after the load: {out['inventory_after_load']}")
        log(f"  rollover to {ABSENT_SIGNATURE}: aborted after {abort_s:.3f} s (warm timeout "
            f"{FLEET_WARM_TIMEOUT_S} s), the fleet keeps serving the second weights")
        out.update({"start_to_warm_s": start_to_warm, "per_key": per_key,
                    "fleet_worker_per_capture": FLEET_COUNTS[0],
                    "card_used_gib": {"before": used_before, "two_workers": used_2,
                                      "rollover_peak": peak["used"]},
                    "routed_vs_in_process": routed, "latency_ms": latency})
    except BaseException:
        log(f"  fleet failed; router log:\n{_tail(err_path)}")
        for name in sorted(os.listdir(fleet_dir)) if os.path.isdir(fleet_dir) else ():
            if name.endswith(".log"):
                log(f"  {name}:\n{_tail(os.path.join(fleet_dir, name))}")
        raise
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        try:
            stdout, _ = proc.communicate(timeout=150)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, _ = proc.communicate(timeout=30)
        err.close()
        for ref in refs:
            ref.close()
    check(proc.returncode == 0, f"the fleet exited {proc.returncode}")
    record = _check_contract("fleet", stdout)
    check(record["restarts"] == 1 and record["rollovers"] == 1 and record["ok"],
          f"fleet/v1 {record}")
    out["contract"] = {k: record[k] for k in ("restarts", "rollovers", "failovers", "routed")}
    log(f"  fleet drained: exit 0, fleet/v1 {out['contract']}")
    return out


def run_fleet_phase(cfg, seed, device, smi, work) -> dict:
    """Phase 11: the split-phase routes in process, then the fleet."""
    log("== phase 11: split-phase routes and the serving fleet (flagship width)")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    routes = run_routes(cfg, seed, device, work)
    route_files = [os.path.join(work, f"route{i}.npz") for i in range(len(ROUTE_LIBRARY))]
    fleet = run_fleet(cfg, seed, device, smi, work, route_files)
    seconds = time.perf_counter() - t0
    log(f"  phase 11: {seconds:.1f} s")
    return {"routes": routes, **fleet, "seconds": seconds}


# ---------------------------------------------------------------------------
# Phase 12: the training dispatch loop and its input path
# ---------------------------------------------------------------------------

# 20 train complexes in two buckets of 10 (128x128 and 256x192): per bucket
# a run of 8 and a remainder of 2 at --batch_size 1 --steps_per_dispatch 8,
# so 2 run dispatches and 4 per-batch ones; distinct sizes name each
# complex. 4 val complexes of one bucket (one eval dispatch of 4) and 4
# test complexes of mixed buckets.
DISPATCH_TRAIN = tuple((70 + 5 * i, 100 - 3 * i) for i in range(10)) + \
    tuple((200 + 5 * i, 150 + 3 * i) for i in range(10))
DISPATCH_VAL = ((80, 120), (90, 110), (100, 95), (120, 70))
DISPATCH_TEST = ((60, 250), (100, 80), (200, 180), (128, 128))
DISPATCH_K = 8
DISPATCH_EVAL_K = 4
DISPATCH_PROFILE_STEPS = 2


def write_dispatch_dataset(root, seed) -> None:
    """The phase's on-disk tree: train, val and test split files over
    their own complexes."""
    sizes = DISPATCH_TRAIN + DISPATCH_VAL + DISPATCH_TEST
    write_tiny_npz_dataset(root, sizes=sizes, seed=seed, knn=constants.KNN,
                           geo_nbrhd_size=constants.GEO_NBRHD_SIZE)
    names = [f"c{i}.npz" for i in range(len(sizes))]
    n_train, n_val = len(DISPATCH_TRAIN), len(DISPATCH_VAL)
    for mode, sel in (("train", names[:n_train]), ("val", names[n_train:n_train + n_val]),
                      ("test", names[n_train + n_val:])):
        with open(os.path.join(root, f"pairs-postprocessed-{mode}.txt"), "w") as f:
            f.write("\n".join(sel) + "\n")


class _Recorder:
    """An in-process metric writer: the scalars and images it was given."""

    def __init__(self):
        self.scalars, self.images = [], []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, value, step))

    def add_image(self, tag, img, step, dataformats="HWC"):
        self.images.append((tag, tuple(img.shape), step))


@contextlib.contextmanager
def _visited(into: list):
    """Record each train step's (n1, n2), loss and grad norm, in order, by
    wrapping the loop's multi_train_step. Nothing is read inside the run:
    the device values are kept and read after it."""
    from deepinteract_tpu_torch.training import loop as loop_mod

    real = loop_mod.multi_train_step

    def steps(state, batches, *a, **kw):
        m = real(state, batches, *a, **kw)
        into.extend((b.graph1.num_nodes, b.graph2.num_nodes, m["loss"][j], m["grad_norm"][j])
                    for j, b in enumerate(batches))
        return m

    loop_mod.multi_train_step = steps
    try:
        yield
    finally:
        loop_mod.multi_train_step = real


def _read_visited(visited: list) -> list:
    """[(n1, n2, loss, grad_norm)] on the host."""
    return [(int(a[0]), int(b[0]), float(loss), float(norm)) for a, b, loss, norm in visited]


def _dispatches(loader, k: int = DISPATCH_K, buckets: bool = False) -> list:
    """Steps per train dispatch of the loader's epoch-0 plan, by the
    loop's rule: a run of exactly K same-bucket batches is one dispatch,
    a shorter run one dispatch per batch. With ``buckets``, (bucket,
    steps) pairs."""
    runs = []
    for bucket, _ in loader.epoch_plan(0):
        if runs and runs[-1][0] == bucket and runs[-1][1] < k:
            runs[-1][1] += 1
        else:
            runs.append([bucket, 1])
    out = [(b, d) for b, n in runs for d in ([n] if n == k else [1] * n)]
    return out if buckets else [d for _, d in out]


def _pack_stamps(pack_root) -> dict:
    out = {}
    for split in ("train", "val", "test"):
        st = os.stat(os.path.join(pack_root, split, "pack_index.json"))
        out[split] = (st.st_ino, st.st_mtime_ns)
    return out


def _trace_counts(profile_dir) -> dict:
    """K1 kernels, K2 kernels (its second pass, one per launch) and the
    device_step and h2d ranges of the exported Chrome trace."""
    with open(os.path.join(profile_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    names = [e.get("name", "") for e in events]
    return {"k1": sum("edge_attention_fwd" in n for n in kernels),
            "k2": sum("edge_attention_bwd_dst" in n for n in kernels),
            "kernels": len(kernels), "device_step": names.count("device_step"),
            "h2d": names.count("h2d"),
            "steps": sorted({n for n in names if n.startswith("step#")})}


def run_dispatch_loop(seed, device, smi, flags=()) -> dict:
    """Phase 12: ``cli.train`` at the flagship width with K train steps and
    K eval batches per dispatch, inline (run A) and with the placement
    thread, packs, a profile window, viz and an in-process writer (run B),
    both under ``--deterministic``: bitwise equal weights, AdamW moments and
    per-step losses, the visited order of the loader's run-granular plan
    (F7), exact launch counts, the trace's kernels and ranges, the span
    log's dispatches, pack reuse, and a ``data.place`` fault surfacing as
    ``PlacementError``. ``flags`` go to every command (a CPU rehearsal's
    small model and ``--device cpu``)."""
    from deepinteract_tpu_torch.obs import metrics as obs_metrics
    from deepinteract_tpu_torch.obs import spans as obs_spans

    pinned_gauge = obs_metrics.get_registry().gauge("di_data_pinned_peak_bytes")

    log("== phase 12: training dispatch loop and input path (cli.train, flagship width, "
        f"--steps_per_dispatch {DISPATCH_K}, --eval_batches_per_dispatch {DISPATCH_EVAL_K})")
    t_phase = time.perf_counter()
    obs_spans.close()  # the runs open their own span logs
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dispatch_") as work:
        root, packs, prof = (os.path.join(work, d) for d in ("data", "packs", "profile"))
        write_dispatch_dataset(root, seed)
        def argv(ckpt, *extra):
            return ["--dips_root", root, "--num_epochs", "1", "--seed", str(seed),
                    "--log_every", "0", "--deterministic", "--steps_per_dispatch",
                    str(DISPATCH_K), "--eval_batches_per_dispatch", str(DISPATCH_EVAL_K),
                    "--ckpt_dir", os.path.join(work, ckpt), *extra, *flags]

        prefetch_flags = ("--device_prefetch", "--packed_cache_dir", packs, "--profile_dir",
                          prof, "--profile_steps", str(DISPATCH_PROFILE_STEPS),
                          "--viz_every_n_epochs", "1")
        runs, visited, walls = {}, {}, {}
        writer = _Recorder()
        real_writer = train_cli.make_metric_writer
        for name, extra in (("A", ()), ("B", prefetch_flags)):
            visited[name] = []
            train_cli.make_metric_writer = (lambda args: writer) if name == "B" \
                else real_writer
            pinned_gauge.set(0)
            try:
                with _visited(visited[name]):
                    t0 = time.perf_counter()
                    runs[name] = _counted(lambda: train_cli.run(train_cli.parse_args(
                        argv(name, *extra))))
                    walls[name] = time.perf_counter() - t0
            finally:
                train_cli.make_metric_writer = real_writer
            runs[name] += (int(pinned_gauge.value()),)
        (hist_a, test_a), counts_a, _ = runs["A"]
        (hist_b, test_b), counts_b, pinned_peak = runs["B"]

        # A third run B on the same packs under a data.place fault plan: it
        # must reuse them and end non-zero with PlacementError. It starts
        # now and is waited for after the checks below.
        stamps = _pack_stamps(packs)
        env = {k: v for k, v in os.environ.items() if k != "DI_FAULTS"}
        env["DI_FAULTS"] = "data.place=1"
        t_fault = time.perf_counter()
        fault = subprocess.Popen([sys.executable, "-m", "deepinteract_tpu_torch.cli.train",
                                  *argv("C", *prefetch_flags)], env=env, text=True,
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 cwd=os.path.dirname(os.path.abspath(__file__)))
        try:
            # The same weights, AdamW moments and schedule, bitwise.
            finals = {n: Checkpointer(CheckpointConfig(directory=os.path.join(work, n))).restore(
                None, which="last") for n in ("A", "B")}
            state_diff = _tree_diff(finals["A"], finals["B"])
            check(state_diff == 0.0, f"inline and --device_prefetch runs differ: last/ state max "
                  f"|diff| {state_diff:.3g}")
            steps = {n: _read_visited(v) for n, v in visited.items()}
            check([s[2] for s in steps["A"]] == [s[2] for s in steps["B"]],
                  "inline and --device_prefetch runs differ in their per-step losses")
            for key in hist_a[0]:
                if key.endswith("seconds") or key.startswith("tele_"):  # timings
                    continue
                check(_same_metric(hist_a[0][key], hist_b[0][key], 0.0),
                      f"history {key}: inline {hist_a[0][key]} vs prefetch {hist_b[0][key]}")
            check(all(_same_metric(test_a[k], test_b[k], 0.0) for k in test_a),
                  f"test metrics differ: {test_a} vs {test_b}")
            # F7 on the card: the visited order is the run-granular plan.
            plan_loader = BucketedLoader(DIPSDataset(root, "train"), shuffle=True,
                                         drop_remainder=True, seed=seed, dispatch_run=DISPATCH_K)
            lengths = plan_loader.dataset.lengths()
            plan_sizes = [tuple(lengths[i]) for _, chunk in plan_loader.epoch_plan(0)
                          for i in chunk]
            for n in ("A", "B"):
                check([s[:2] for s in steps[n]] == plan_sizes,
                      f"run {n}: visited {[s[:2] for s in steps[n]]}, plan {plan_sizes}")
            dispatches = _dispatches(plan_loader)
            check(sorted(dispatches) == [1, 1, 1, 1, DISPATCH_K, DISPATCH_K],
                  f"dispatches {dispatches}")
            # Exact launch counts: the step graphs' captures (2 train keys, 3
            # eval keys) and run B's eager viz forward.
            train_b, eval_b = _split(root, "train"), _split(root, "val") + _split(root, "test")
            for n, counts, extra_evals in (("A", counts_a, 0), ("B", counts_b, 1)):
                _expect_graphed(f"run {n}", counts, train_b, eval_b, extra_evals)
            # The profile window: dispatches [1, 1 + profile_steps). A key's
            # first dispatch runs its warm-up steps eagerly before the capture.
            window = _dispatches(plan_loader, buckets=True)[:1 + DISPATCH_PROFILE_STEPS]
            first = {}
            for i, (bucket, _) in enumerate(window):
                first.setdefault(bucket, i)
            warmups = step_graphs.WARMUP_RUNS * sum(i >= 1 for i in first.values())
            window_steps = sum(d for _, d in window[1:])
            trace = _trace_counts(prof)
            want = LAUNCHES_PER_ENCODE_PAIR * (window_steps + warmups)
            check((trace["k1"], trace["k2"]) == (want, want),
                  f"trace K1/K2 kernels {trace['k1']}/{trace['k2']}, expected {want} each "
                  f"({window_steps} steps in dispatches 1..{DISPATCH_PROFILE_STEPS}, "
                  f"{warmups} warm-up steps)")
            check(trace["device_step"] >= DISPATCH_PROFILE_STEPS and trace["h2d"] >= 1,
                  f"trace ranges: device_step {trace['device_step']}, h2d {trace['h2d']}")
            check(trace["steps"] == [f"step#{i}" for i in range(1, 1 + DISPATCH_PROFILE_STEPS)],
                  f"trace step ranges {trace['steps']}")
            # The span log: 6 train dispatches with their leaves.
            events = obs_spans.read_events(os.path.join(work, "A", "obs", "events.jsonl"))
            counted = {k: sum(e["name"] == k for e in events)
                       for k in ("step", "device_step", "h2d", "data_wait")}
            check(counted["step"] == counted["device_step"] == counted["h2d"] == len(dispatches)
                  and counted["data_wait"] >= 1,
                  f"span log of run A: {counted}, expected {len(dispatches)} dispatches")
            check([e["n"] for e in events if e["name"] == "step"] == dispatches,
                  "span log step sizes differ from the plan's dispatches")
            # Viz and scalars through the in-process writer.
            check([t for t, *_ in writer.images] == ["val_predicted_contact_probs",
                                                     "val_true_contacts"]
                  and writer.images[0][1] == (*DISPATCH_VAL[0], 1),
                  f"viz images {writer.images}")
            check(any(t == "val_ce" for t, *_ in writer.scalars), "no val_ce scalar written")
            fault_out, _ = fault.communicate(timeout=600)
        finally:
            if fault.poll() is None:  # a failed check above: stop it
                fault.kill()
                fault.communicate()
        fault_s = time.perf_counter() - t_fault
        check(fault.returncode != 0 and "PlacementError" in fault_out,
              f"data.place run: rc {fault.returncode}, {fault_out[-800:]}")
        check(_pack_stamps(packs) == stamps, "the third run B rebuilt a pack")
    tele = {n: {k: h[0][k] for k in ("tele_data_wait_frac", "tele_data_wait_s", "tele_h2d_s",
                                     "tele_h2d_frac", "tele_device_frac", "tele_device_s",
                                     "tele_eval_s", "train_seconds", "epoch_seconds")}
            for n, h in (("inline", hist_a), ("prefetch", hist_b))}
    seconds = time.perf_counter() - t_phase
    for n, label in (("A", "inline"), ("B", "prefetch")):
        t = tele[label]
        log(f"  run {n} ({label}): cli.train wall {walls[n]:.3f} s, epoch "
            f"{t['epoch_seconds']:.3f} s (train {t['train_seconds']:.3f} s), data_wait "
            f"{t['tele_data_wait_s']:.4f} s ({t['tele_data_wait_frac']:.4%}), h2d "
            f"{t['tele_h2d_s']:.4f} s, device {t['tele_device_frac']:.2%}; launches "
            f"{runs[n][1]}")
    log(f"  prefetch: pinned bytes at the peak {pinned_peak} ({pinned_peak / 2 ** 20:.2f} "
        f"MiB); last/ state bitwise equal; {len(dispatches)} dispatches {dispatches}; trace "
        f"window {window_steps} steps, K1 {trace['k1']} K2 {trace['k2']} of "
        f"{trace['kernels']} kernels; packs reused; data.place run exit "
        f"{fault.returncode} with PlacementError ({fault_s:.1f} s, beside the checks); "
        f"card {smi}")
    log(f"  phase 12: {seconds:.1f} s")
    return {"launches": {"inline": counts_a, "prefetch": counts_b}, "dispatches": dispatches,
            "walls_s": walls, "telemetry": tele, "pinned_peak_bytes": pinned_peak,
            "trace": trace, "window_steps": window_steps, "seconds": seconds}


# ---------------------------------------------------------------------------
# Phase 13: the train and eval steps as CUDA graphs
# ---------------------------------------------------------------------------

STEP_GRAPH_DROPOUT = 0.1
STEP_GRAPH_POISON = 5  # the poisoned batch: the fifth of the epoch's first run of K
STEP_GRAPH_TIMED_RUNS = 1  # full runs of K timed per path
# Other configurations: one graphed run of K = 2 against eager, bitwise.
STEP_GRAPH_CONFIGS = {"deeplab": ((100, 80), (110, 90)), "gcn": ((100, 80), (110, 90)),
                      "attention": ((100, 80), (110, 90)), "tiled_remat": TILED_TRAIN}
CSR_BUILD_KERNEL = "searchsorted"  # the in-edge CSR build's last kernel, one per build


def _cli_train_run(argv, graphs: bool, nan_at=None):
    """``cli.train`` in process with ``LoopConfig.step_graphs`` set to
    ``graphs``, batch ``nan_at`` (1-based) poisoned by the fault plan:
    (history, test metrics, launches, [(n1, n2, loss, grad_norm)], wall)."""
    real = train_cli.loop_config_from_args
    train_cli.loop_config_from_args = lambda a: dataclasses.replace(real(a), step_graphs=graphs)
    visited = []
    if nan_at is not None:
        faults.configure({"train.nan_batch": [nan_at]})
    try:
        with _visited(visited):
            t0 = time.perf_counter()
            (history, test), counts = _counted(lambda: train_cli.run(train_cli.parse_args(argv)))
            wall = time.perf_counter() - t0
    finally:
        train_cli.loop_config_from_args = real
        faults.reset()
    return history, test, counts, _read_visited(visited), wall


def _same_floats(a, b) -> bool:
    """Bitwise equal sequences of floats (NaN equals NaN)."""
    return len(a) == len(b) and all(x == y or (x != x and y != y) for x, y in zip(a, b))


def _profile_kernels(fn) -> dict:
    """One call of ``fn`` under torch.profiler: K1 kernels, K2 kernels (its
    second pass, one per launch), CSR builds and all device kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"k1": sum("edge_attention_fwd" in n for n in names),
            "k2": sum("edge_attention_bwd_dst" in n for n in names),
            "csr_builds": sum(CSR_BUILD_KERNEL in n for n in names), "kernels": len(names)}


def _full_run_ms(state, run, graphs) -> float:
    """A full run of K steps dispatched and its metrics read once, as the
    loop does: host ms per step (median of STEP_GRAPH_TIMED_RUNS)."""
    from deepinteract_tpu_torch.training.loop import _Fetch

    walls = []
    for _ in range(STEP_GRAPH_TIMED_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _Fetch(multi_train_step(state, run, guard=True, graphs=graphs)).rows()
        walls.append((time.perf_counter() - t0) * 1e3 / len(run))
    return statistics.median(walls)


def _config_batches(work, name, sizes, seed) -> list:
    root = os.path.join(work, f"cfg_{name}")
    write_tiny_npz_dataset(root, sizes=sizes, seed=seed, knn=constants.KNN,
                           geo_nbrhd_size=constants.GEO_NBRHD_SIZE)
    batches = _split(root, "train")
    check(_keys(batches) == 1, f"{name}: the batches span {_keys(batches)} keys, expected 1")
    return batches


def run_step_graph_configs(cfg, seed, device, work) -> dict:
    """DeepLab, the GCN encoder, regional attention and two-tile decoding
    with ``--remat``: one graphed run of K = 2 against two eager steps
    from the same weights
    under deterministic algorithms: metrics and every state tensor
    bitwise, and the capture's (K1, K2, CSR builds)."""
    variants = {
        "deeplab": dataclasses.replace(cfg, interact_module_type="deeplab"),
        "gcn": dataclasses.replace(cfg, gnn_layer_type="gcn"),
        "attention": dataclasses.replace(cfg, decoder=dataclasses.replace(
            cfg.decoder, use_attention=True)),
        "tiled_remat": dataclasses.replace(cfg, tile_pair_map=True, decoder=dataclasses.replace(
            cfg.decoder, remat=True))}
    out = {}
    torch.use_deterministic_algorithms(True)
    try:
        for name, c in variants.items():
            batches = [b.to(device) for b in _config_batches(work, name,
                                                             STEP_GRAPH_CONFIGS[name], seed)]
            eager = create_train_state(load_model(c, device, seed=seed), seed=seed)
            graphed = create_train_state(load_model(c, device, seed=seed), seed=seed)
            graphs = step_graphs.StepGraphs(graphed, guard=True)
            m_e = multi_train_step(eager, batches, guard=True)
            m_g = multi_train_step(graphed, batches, guard=True, graphs=graphs)
            for key in m_e:
                check(torch.equal(m_e[key], m_g[key]),
                      f"{name}: graphed {key} {m_g[key].tolist()} vs eager {m_e[key].tolist()}")
            diff = max((a.double() - b.double()).abs().max().item()
                       for a, b in zip(eager.tensors(), graphed.tensors()) if a.numel())
            check(diff == 0.0, f"{name}: graphed state differs from eager by {diff:.3g}")
            (entry,) = graphs.train_entries.values()
            want = (0 if name == "gcn" else LAUNCHES_PER_ENCODE_PAIR,) * 2 + (
                BUILDS_PER_ENCODE_PAIR,)
            counts = (entry.k1_launches, entry.k2_launches, entry.csr_builds)
            check(counts == want, f"{name}: capture counts {counts}, expected {want}")
            out[name] = {"capture_s": entry.seconds, "capture_counts": counts,
                         "losses": m_g["loss"].tolist()}
            log(f"  {name}: graphed run of 2 equals eager bitwise (metrics, state), capture "
                f"{entry.seconds:.2f} s, (K1, K2, CSR builds) {counts}")
            del eager, graphed, graphs
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    return out


def run_step_graphs(seed, device, smi, flags=()) -> dict:
    """Phase 13: ``cli.train`` on phase 12's dataset under
    ``--deterministic`` at dropout 0.1, eager (``step_graphs=False``) and
    graphed, clean and with one batch of a run of 8 poisoned: per-step
    losses and grad norms, histories, last/ states (weights, AdamW
    moments and count, batch-norm statistics) and test metrics bitwise
    equal, exact launch counts; then on a state of its own: the captures'
    counts and seconds, one profiled replay of each kind against an eager
    step, a full run's per-step wall graphed and eager, the host's
    blocking reads per run, peak memory; then the other configurations."""
    log("== phase 13: train and eval steps as CUDA graphs (cli.train eager vs graphed, "
        "--deterministic, dropout 0.1; DeepLab, GCN, tiled remat)")
    t_phase = time.perf_counter()
    from deepinteract_tpu_torch.obs import spans as obs_spans

    obs_spans.close()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_graphs_") as work:
        root = os.path.join(work, "data")
        write_dispatch_dataset(root, seed)
        plan = _dispatches(BucketedLoader(DIPSDataset(root, "train"), shuffle=True,
                                          drop_remainder=True, seed=seed,
                                          dispatch_run=DISPATCH_K), buckets=True)
        start = 0
        for _, d in plan:
            if d == DISPATCH_K:
                break
            start += d
        nan_at = start + STEP_GRAPH_POISON

        def argv(ckpt):
            return ["--dips_root", root, "--num_epochs", "1", "--seed", str(seed),
                    "--log_every", "0", "--deterministic", "--dropout_rate",
                    str(STEP_GRAPH_DROPOUT), "--steps_per_dispatch", str(DISPATCH_K),
                    "--eval_batches_per_dispatch", str(DISPATCH_EVAL_K), "--ckpt_dir",
                    os.path.join(work, ckpt), *flags]

        runs = {}
        for name, graphs, poison in (("eager", False, None), ("graphed", True, None),
                                     ("eager_nan", False, nan_at),
                                     ("graphed_nan", True, nan_at)):
            runs[name] = _cli_train_run(argv(name), graphs, poison)
        finals = {n: Checkpointer(CheckpointConfig(directory=os.path.join(work, n))).restore(
            None, which="last") for n in runs}
        train_b, eval_b = _split(root, "train"), _split(root, "val") + _split(root, "test")
        for a, b in (("eager", "graphed"), ("eager_nan", "graphed_nan")):
            (hist_a, test_a, _, steps_a, _), (hist_b, test_b, _, steps_b, _) = runs[a], runs[b]
            diff = _tree_diff(finals[a], finals[b])
            check(diff == 0.0, f"{b}: last/ state differs from {a}'s by {diff:.3g}")
            check([s[:2] for s in steps_a] == [s[:2] for s in steps_b]
                  and _same_floats([s[2] for s in steps_a], [s[2] for s in steps_b])
                  and _same_floats([s[3] for s in steps_a], [s[3] for s in steps_b]),
                  f"{b}: per-step losses or grad norms differ from {a}'s")
            for key in hist_a[0]:
                if key.endswith("seconds") or key.startswith("tele_"):
                    continue
                check(_same_metric(hist_a[0][key], hist_b[0][key], 0.0),
                      f"{b}: history {key} {hist_b[0][key]} vs {a}'s {hist_a[0][key]}")
            check(all(_same_metric(test_a[k], test_b[k], 0.0) for k in test_a),
                  f"{b}: test metrics differ from {a}'s")
        for name in ("eager_nan", "graphed_nan"):
            skipped = runs[name][0][0]["train_skipped_steps"]
            check(skipped == 1, f"{name}: {skipped} skipped steps, expected 1")
            check(not math.isfinite(runs[name][3][nan_at - 1][2]),
                  f"{name}: step {nan_at} was not the poisoned one")
        for name in ("graphed", "graphed_nan"):
            _expect_graphed(name, runs[name][2], train_b, eval_b)
        for name in ("eager", "eager_nan"):
            _expect_launches(name, runs[name][2], len(train_b) + len(eval_b), len(train_b))

        # A state of its own: captures, profiled replays, timed runs.
        model_cfg = model_config_from_args(train_cli.parse_args(argv("own")))
        state = create_train_state(load_model(model_cfg, device, seed=seed), seed=seed)
        graphs = step_graphs.StepGraphs(state, guard=True)
        placed = [b.to(device) for b in train_b]
        by_key = {}
        for b in placed:
            by_key.setdefault(step_graphs.batch_key(b), []).append(b)
        runs_k = [v[:DISPATCH_K] for v in by_key.values()]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for run in runs_k:
            graphs.train(run[0])
        evals = [b.to(device) for b in eval_b]
        for b in evals:
            graphs.eval(b)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for e in graphs.entries():
            want = (LAUNCHES_PER_ENCODE_PAIR, LAUNCHES_PER_ENCODE_PAIR if e.kind == "train"
                    else 0, BUILDS_PER_ENCODE_PAIR)
            counts = (e.k1_launches, e.k2_launches, e.csr_builds)
            check(counts == want, f"{e.kind} capture counts {counts}, expected {want}")
        big = max(runs_k, key=lambda r: r[0].contact_map.numel())
        train_prof = _profile_kernels(lambda: graphs.train(big[0]))
        eval_prof = _profile_kernels(lambda: graphs.eval(evals[0]))
        eager_prof = _profile_kernels(lambda: train_step(state, big[0], guard=True))
        check((train_prof["k1"], train_prof["k2"], train_prof["csr_builds"])
              == (LAUNCHES_PER_ENCODE_PAIR, LAUNCHES_PER_ENCODE_PAIR, BUILDS_PER_ENCODE_PAIR),
              f"profiled train replay: {train_prof}")
        check((eval_prof["k1"], eval_prof["k2"], eval_prof["csr_builds"])
              == (LAUNCHES_PER_ENCODE_PAIR, 0, BUILDS_PER_ENCODE_PAIR),
              f"profiled eval replay: {eval_prof}")
        # The host's blocking reads in a full run: none while it is
        # dispatched (sync debug mode warns on each), one for its metrics.
        import warnings

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                metrics = multi_train_step(state, big, guard=True, graphs=graphs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        # (The mode's own notice that it is a prototype is no sync.)
        syncs = sum("called a synchronizing" in str(w.message) for w in caught)
        check(syncs == 0, f"a graphed run synchronized {syncs} times: "
              f"{[str(w.message)[:120] for w in caught[:3]]}")
        from deepinteract_tpu_torch.training.loop import _Fetch

        rows = _Fetch(metrics).rows()
        check(len(rows) == len(big) and all(math.isfinite(r["loss"]) for r in rows),
              f"graphed run metrics {rows}")
        step_ms = {"graphed": _full_run_ms(state, big, graphs),
                   "eager": _full_run_ms(state, big, None)}
        bucket = tuple(big[0].contact_map.shape[1:])
        inventory = graphs.inventory()
        del state, graphs, placed, by_key, runs_k, evals, big
        torch.cuda.empty_cache()
        configs = run_step_graph_configs(model_cfg, seed, device, work)

    tele = {n: {k: runs[n][0][0][k] for k in ("epoch_seconds", "train_seconds",
                                               "tele_device_frac", "tele_device_s",
                                               "tele_eval_s")} for n in runs}
    seconds = time.perf_counter() - t_phase
    for n, t in tele.items():
        log(f"  {n}: cli.train wall {runs[n][4]:.3f} s, epoch {t['epoch_seconds']:.3f} s "
            f"(train {t['train_seconds']:.3f} s, eval {t['tele_eval_s']:.3f} s), device "
            f"{t['tele_device_frac']:.2%} ({t['tele_device_s']:.3f} s), launches {runs[n][2]}")
    log(f"  eager vs graphed bitwise equal (per-step losses and grad norms, history, last/ "
        f"state, test metrics), clean and with batch {nan_at} poisoned (1 skipped step each)")
    for e in inventory:
        log(f"  capture {e['kind']} {e['key'][-1]}: {e['capture_s']:.2f} s (warm-up "
            f"{e['warm_up_s']:.2f}, set-up {e['enter_s']:.2f}, body {e['body_s']:.2f}, "
            f"instantiate {e['instantiate_s']:.2f}), (K1, K2, CSR) {e['counts']}")
    log(f"  a profiled train replay at {bucket}: K1 {train_prof['k1']} K2 {train_prof['k2']} "
        f"CSR builds {train_prof['csr_builds']} of {train_prof['kernels']} kernels; an eager "
        f"step {eager_prof['kernels']} kernels; an eval replay K1 {eval_prof['k1']} K2 "
        f"{eval_prof['k2']} CSR {eval_prof['csr_builds']} of {eval_prof['kernels']}")
    log(f"  full run of {DISPATCH_K} at {bucket}: {step_ms['graphed']:.3f} ms a step graphed, "
        f"{step_ms['eager']:.3f} ms eager (median of {STEP_GRAPH_TIMED_RUNS}); blocking reads "
        f"per run 1 (syncs while dispatching {syncs}); peak {peak:.3f} GiB with "
        f"{len(inventory)} captures; card {smi}")
    log(f"  phase 13: {seconds:.1f} s")
    return {"launches": {n: runs[n][2] for n in runs}, "telemetry": tele,
            "walls_s": {n: runs[n][4] for n in runs}, "poisoned_batch": nan_at,
            "captures": inventory, "profiled_train_replay": train_prof,
            "profiled_eval_replay": eval_prof, "profiled_eager_step": eager_prof,
            "full_run_step_ms": step_ms, "full_run_bucket": bucket,
            "blocking_reads_per_run": 1, "syncs_while_dispatching": syncs,
            "peak_gib": peak, "configs": configs, "seconds": seconds}


# ---------------------------------------------------------------------------
# Phase 14: the featurization front end (two PDB files -> contact map)
# ---------------------------------------------------------------------------

FRONTEND_CHAINS = (180, 140)  # the PDB pair predicted and served: buckets 192 / 192
FRONTEND_OFFSET = 11.0  # A between two helix axes: their side chains touch
FRONTEND_BOUND = (90, 80)  # the bound two-chain file
FRONTEND_BUILDER = ((40, 36), (52, 44), (60, 48), (34, 45))  # cli.build_dataset's pairs
FRONTEND_TIMED_RUNS = 3  # PDB files -> map in process, median of
FRONTEND_LIMIT_S = 60.0
NATIVE_BAR = dict(rtol=1e-4, atol=1e-3)  # native vs numpy: the JAX tests/test_pipeline.py
# Heavy side-chain atoms of the 20 standard residues (PDB names).
SIDE_CHAINS = {
    "ALA": ("CB",), "GLY": (), "SER": ("CB", "OG"), "CYS": ("CB", "SG"),
    "VAL": ("CB", "CG1", "CG2"), "THR": ("CB", "OG1", "CG2"),
    "LEU": ("CB", "CG", "CD1", "CD2"), "ILE": ("CB", "CG1", "CG2", "CD1"),
    "MET": ("CB", "CG", "SD", "CE"), "PRO": ("CB", "CG", "CD"),
    "PHE": ("CB", "CG", "CD1", "CD2", "CE1", "CE2", "CZ"),
    "TYR": ("CB", "CG", "CD1", "CD2", "CE1", "CE2", "CZ", "OH"),
    "TRP": ("CB", "CG", "CD1", "CD2", "NE1", "CE2", "CE3", "CZ2", "CZ3", "CH2"),
    "ASP": ("CB", "CG", "OD1", "OD2"), "GLU": ("CB", "CG", "CD", "OE1", "OE2"),
    "ASN": ("CB", "CG", "OD1", "ND2"), "GLN": ("CB", "CG", "CD", "OE1", "NE2"),
    "LYS": ("CB", "CG", "CD", "CE", "NZ"), "ARG": ("CB", "CG", "CD", "NE", "CZ", "NH1", "NH2"),
    "HIS": ("CB", "CG", "ND1", "CD2", "CE1", "NE2"),
}


def pdb_chain_lines(n_res, chain, x0=0.0, first=0, serial=1) -> list:
    """ATOM records of an alpha helix of ``n_res`` residues (100 degrees and
    1.5 A a residue, axis along z through (x0, 0)) cycling through the 20
    standard residues from type ``first``, side chains pointing away from
    the axis."""
    resnames = list(SIDE_CHAINS)
    backbone = {"N": (1.56, -0.48, -0.60), "CA": (2.28, 0.0, 0.0), "C": (1.68, 0.50, 0.65),
                "O": (2.00, 0.70, 1.80)}
    lines = []
    for i in range(n_res):
        resname = resnames[(first + i) % len(resnames)]
        phi0, z0 = math.radians(100.0) * i, 1.5 * i
        atoms = [(name, r, phi0 + dphi, z0 + dz) for name, (r, dphi, dz) in backbone.items()]
        atoms += [(name, 3.3 + 1.1 * k, phi0 - 0.2 + 0.3 * (k % 3 - 1), z0 - 0.5 + 0.4 * (k % 2))
                  for k, name in enumerate(SIDE_CHAINS[resname])]
        for name, r, phi, z in atoms:
            x, y = x0 + r * math.cos(phi), r * math.sin(phi)
            lines.append(f"ATOM  {serial:5d} {name:<4s} {resname} {chain}{i + 1:4d}    "
                         f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00          {name[0]:>2s}")
            serial += 1
    return lines


def write_pdb_file(path, *chains) -> str:
    """A PDB file of one or more helices, each ``(n_res, chain id, x0,
    first residue type)``."""
    lines = []
    for n_res, chain, x0, first in chains:
        lines += pdb_chain_lines(n_res, chain, x0, first, serial=len(lines) + 1) + ["TER"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\nEND\n")
    return path


def check_native_features(chains) -> dict:
    """Each native geometry kernel against its numpy version on the parsed
    chains (the JAX package's bar): max |diff| per kernel."""
    from deepinteract_tpu_torch.pipeline import native
    from deepinteract_tpu_torch.pipeline import residue_features as rf

    def cross_numpy(a, b):
        full = np.sqrt(np.maximum(np.sum((a.coords[:, None] - b.coords[None]) ** 2, -1), 0.0))
        d = np.minimum.reduceat(full, a.atom_start[:-1], axis=0)
        return np.minimum.reduceat(d, b.atom_start[:-1], axis=1)

    a, b = chains
    cases = [("cross_min_dist", native.cross_min_dist_matrix(a.coords, a.atom_start, b.coords,
                                                              b.atom_start), cross_numpy(a, b))]
    for ch in chains:
        radii = rf.atom_radii(ch.elements)
        sasa, depth = native.sasa_and_depth(ch.coords, radii, rf.N_SPHERE, rf.PROBE_RADIUS)
        sasa_np, depth_np = rf._sasa_and_depth_numpy(ch.coords, radii)
        cases += [("sasa", sasa, sasa_np), ("depth", depth, depth_np),
                  ("min_dist", native.min_dist_matrix(ch.coords, ch.atom_start),
                   rf._min_dist_matrix_numpy(ch.coords, ch.atom_start)),
                  ("protrusion_cx", native.protrusion_cx(ch.coords, rf.CX_SPHERE_RADIUS,
                                                         rf.CX_ATOM_VOLUME),
                   rf._protrusion_cx_numpy(ch.coords))]
    out = {}
    for name, got, want in cases:
        err = float(np.abs(got - want).max())
        check(got.shape == want.shape and np.allclose(got, want, **NATIVE_BAR),
              f"native {name} vs numpy: max |diff| {err:.3g} (rtol 1e-4, atol 1e-3)")
        out[name] = max(out.get(name, 0.0), err)
    return out


def serve_pdb_pair(engine, left, right, device) -> dict:
    """``ServingServer`` on a free port: a JSON ``{"left_pdb", "right_pdb"}``
    POST (featurized on the server) against ``predict_complex`` on the
    featurized pair (1e-6), a second (warm) request timed, then a drain."""
    from deepinteract_tpu_torch.pipeline.pair import convert_pdb_pair_to_complex
    from deepinteract_tpu_torch.robustness.preemption import PreemptionGuard
    from deepinteract_tpu_torch.serving import ServingServer

    server = ServingServer(engine, port=0)
    guard = PreemptionGuard(log=lambda s: None)  # flag-only off the main thread
    rc = {}
    runner = threading.Thread(target=lambda: rc.setdefault("rc", server.run(guard=guard)))
    runner.start()
    try:
        t_end = time.monotonic() + 10
        while server._serve_thread is None and time.monotonic() < t_end:
            time.sleep(0.01)
        host, port = server.address
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            status, out = _post_json(host, port, "/predict", {"left_pdb": left, "right_pdb": right})
            walls.append(time.perf_counter() - t0)
            check(status == 200, f"POST /predict of a PDB pair: status {status}, {str(out)[:300]}")
        served = np.asarray(out["contact_probs"], dtype=np.float32)
        ref = predict_complex(convert_pdb_pair_to_complex(left, right, with_labels=False),
                              engine.model, device)["contact_prob_map"]
        diff = float(np.abs(served - ref).max()) if served.shape == ref.shape else math.inf
        check(diff <= 1e-6, f"served PDB pair {served.shape} vs predict_complex {ref.shape}: "
              f"{diff:.3g} (bar 1e-6)")
    finally:
        guard.request("phase 14 done")
        runner.join(timeout=60)
    check(not runner.is_alive() and rc.get("rc") == 0, "the PDB server did not drain")
    return {"served_vs_predict_max": diff, "first_request_s": walls[0],
            "warm_request_ms": walls[1] * 1e3, "bucket": out["bucket"]}


def run_frontend(seed, device, smi) -> dict:
    """Phase 14: the featurization front end at the flagship width. Inputs
    are PDB files written here; the native geometry library is built from
    this checkout and required."""
    from deepinteract_tpu_torch.cli import analyze as analyze_cli
    from deepinteract_tpu_torch.cli import build_dataset as build_cli
    from deepinteract_tpu_torch.pipeline import native
    from deepinteract_tpu_torch.pipeline.pair import (convert_bound_complex_to_pair,
                                                      convert_pdb_pair_to_complex,
                                                      featurize_structure, load_structure)
    from deepinteract_tpu_torch.serving import EngineConfig, InferenceEngine

    log("== phase 14: featurization front end (PDB files -> cli.predict and a served map, "
        "flagship width; cli.build_dataset, cli.analyze)")
    t_phase = time.perf_counter()
    profile_env = [k for k in ("DI_HHBLITS_BIN", "DI_HHBLITS_DB") if os.environ.get(k)]
    check(not profile_env, f"{profile_env} set: this phase runs the zero-profile mode")
    log("  DI_HHBLITS_BIN / DI_HHBLITS_DB unset: the 27 sequence-profile columns are zeros, "
        "with a warning per chain (the JAX package's mode without hhblits)")
    cxx = subprocess.run([native.compiler(), "--version"], capture_output=True, text=True,
                         check=True).stdout.splitlines()[0]
    native.reset()
    lib = native.library_path()
    found = lib.exists()
    t0 = time.perf_counter()
    ok = native.available()
    build_s = time.perf_counter() - t0
    check(ok, f"native geometry library unavailable: {native.disabled_reason()}")
    log(f"  {cxx}: {lib.relative_to(lib.parents[1])} {'found' if found else 'built'} in "
        f"{build_s:.3f} s")
    n1, n2 = FRONTEND_CHAINS
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pdb_") as work:
        left = write_pdb_file(os.path.join(work, "left_u.pdb"), (n1, "A", 0.0, 0))
        right = write_pdb_file(os.path.join(work, "right_u.pdb"), (n2, "B", FRONTEND_OFFSET, 7))
        chains = [load_structure(left), load_structure(right)]
        check([len(c) for c in chains] == [n1, n2], f"parsed {[len(c) for c in chains]} residues")
        native_errs = check_native_features(chains)
        log(f"  native vs numpy geometry ({sum(c.num_atoms for c in chains)} atoms): max |diff| "
            + ", ".join(f"{k} {v:.3g}" for k, v in native_errs.items())
            + " (rtol 1e-4, atol 1e-3)")
        feat_ms = {}
        for c in chains:
            t0 = time.perf_counter()
            g = featurize_structure(c, rng=np.random.default_rng(seed))
            feat_ms[len(c)] = (time.perf_counter() - t0) * 1e3
            check(g["node_feats"].shape == (len(c), constants.NUM_NODE_FEATS)
                  and all(np.isfinite(v).all() for v in g.values()),
                  f"featurized chain of {len(c)}: not finite or not 113 wide")
        braw = convert_bound_complex_to_pair(
            write_pdb_file(os.path.join(work, "bound.pdb"), (FRONTEND_BOUND[0], "A", 0.0, 3),
                           (FRONTEND_BOUND[1], "B", FRONTEND_OFFSET, 11)), "A", "B")
        bound_contacts = int(braw["examples"][:, 2].sum())
        check(braw["examples"].shape[0] == FRONTEND_BOUND[0] * FRONTEND_BOUND[1]
              and bound_contacts > 0, f"bound complex: {bound_contacts} contacts")
        log(f"  featurize (host, native): {', '.join(f'{n} residues {ms:.1f} ms' for n, ms in feat_ms.items())}; "
            f"bound {FRONTEND_BOUND[0]}x{FRONTEND_BOUND[1]}: {bound_contacts} contacts at 6 A")

        # cli.predict from the two PDB files, then from the npz it saved:
        # the same seeded weights, the same map bit for bit (deterministic
        # algorithms, as phase 5b runs predict).
        npz = os.path.join(work, "pair.npz")
        want = (LAUNCHES_PER_ENCODE_PAIR, 0, BUILDS_PER_ENCODE_PAIR)
        runs = {}
        torch.use_deterministic_algorithms(True)
        try:
            for name, inputs in (("predict_pdb", ["--left_pdb", left, "--right_pdb", right,
                                                  "--save_npz", npz]),
                                 ("predict_npz", ["--input_npz", npz])):
                out_dir = os.path.join(work, name)
                t0 = time.perf_counter()
                _, counts = _counted(lambda: _run_cli(predict_cli.main, [
                    *inputs, "--output_dir", out_dir, "--seed", str(seed)]))
                runs[name] = (counts, time.perf_counter() - t0,
                              np.load(os.path.join(out_dir, "contact_prob_map.npy")))
                check(counts == want, f"{name}: (K1, K2 launches, CSR builds) {counts}, "
                      f"expected {want}")
        finally:
            torch.use_deterministic_algorithms(False)
        probs = runs["predict_pdb"][2]
        check(probs.shape == (n1, n2) and bool(np.isfinite(probs).all()),
              f"PDB map {probs.shape}: expected ({n1}, {n2}), finite")
        check(np.array_equal(probs, runs["predict_npz"][2]),
              "cli.predict from PDB files and from its saved npz differ: max |diff| "
              f"{float(np.abs(probs - runs['predict_npz'][2]).max()):.3g} (bitwise expected)")
        log(f"  cli.predict --left_pdb --right_pdb --save_npz: {n1}x{n2} map finite, (K1, K2, "
            f"CSR builds) {runs['predict_pdb'][0]}, wall {runs['predict_pdb'][1]:.3f} s (model "
            f"init included); --input_npz on the saved npz: bitwise equal map, "
            f"{runs['predict_npz'][0]}")

        # PDB files -> map in process on a loaded model (host clock; the
        # returned numpy map ends each run on the host).
        model = load_model(ModelConfig(), device, seed=seed)
        walls, feats = [], []
        for _ in range(FRONTEND_TIMED_RUNS):
            t0 = time.perf_counter()
            raw = convert_pdb_pair_to_complex(left, right, with_labels=False)
            t1 = time.perf_counter()
            predict_complex(raw, model, device)
            walls.append((time.perf_counter() - t0) * 1e3)
            feats.append((t1 - t0) * 1e3)
        del model
        log(f"  PDB files -> map in process: {statistics.median(walls):.1f} ms, featurization "
            f"{statistics.median(feats):.1f} ms of it (median of {FRONTEND_TIMED_RUNS})")

        engine = InferenceEngine(ModelConfig(), cfg=EngineConfig(max_batch=1, result_cache_size=0),
                                 seed=seed, device=device)
        served = serve_pdb_pair(engine, left, right, device)
        (label, info), = engine.stats()["compile_inventory"].items()
        serve_counts = (info["k1_launches"], info["k2_launches"], info["csr_builds"])
        check(serve_counts == want, f"served PDB key {label}: (K1, K2, CSR builds) "
              f"{serve_counts} at its capture, expected {want}")
        del engine
        torch.cuda.empty_cache()
        log(f"  POST /predict {{left_pdb, right_pdb}}: vs predict_complex "
            f"{served['served_vs_predict_max']:.3g} (bar 1e-6), key {label} captured with "
            f"{serve_counts}; first request {served['first_request_s']:.3f} s (capture "
            f"included), warm {served['warm_request_ms']:.1f} ms (featurization included)")

        # cli.build_dataset over four pairs, cli.analyze, the loader.
        src, ds = os.path.join(work, "pairs"), os.path.join(work, "dataset")
        os.makedirs(src)
        for i, (a, b) in enumerate(FRONTEND_BUILDER):
            write_pdb_file(os.path.join(src, f"c{i}_l_u.pdb"), (a, "A", 0.0, i))
            write_pdb_file(os.path.join(src, f"c{i}_r_u.pdb"), (b, "B", FRONTEND_OFFSET, i + 7))
        t0 = time.perf_counter()
        _run_cli(build_cli.main, ["--input_dir", src, "--output_dir", ds])
        build_dataset_s = time.perf_counter() - t0
        names = sorted(os.listdir(os.path.join(ds, "processed")))
        check(names == [f"c{i}.npz" for i in range(len(FRONTEND_BUILDER))],
              f"build_dataset wrote {names}")
        splits = {}
        for mode in ("train", "val", "test"):
            with open(os.path.join(ds, f"pairs-postprocessed-{mode}.txt")) as f:
                splits[mode] = f.read().split()
        check(sorted(sum(splits.values(), [])) == names, f"split files {splits}")
        stats = json.loads(_run_cli(analyze_cli.main, ["stats", "--root", ds]).splitlines()[-1])
        lengths = json.loads(_run_cli(analyze_cli.main, ["lengths", "--root", ds])
                             .splitlines()[-1])
        sizes = [n for pair in FRONTEND_BUILDER for n in pair]
        check(stats["num_complexes"] == len(names) and stats["total_pos_contacts"] > 0
              and (lengths["min"], lengths["max"]) == (min(sizes), max(sizes)),
              f"analyze stats {stats}, lengths {lengths}")
        loaded = 0
        for mode, entries in splits.items():
            for batch in (BucketedLoader(DIPSDataset(ds, mode)) if entries else ()):
                loaded += int(batch.graph1.num_nodes.shape[0])
                check(bool(torch.isfinite(batch.graph1.node_feats).all()),
                      f"{mode} batch not finite")
        check(loaded == len(names), f"the loader read {loaded} complexes of {len(names)}")
        log(f"  cli.build_dataset: {len(names)} pairs in {build_dataset_s:.3f} s, splits "
            f"{ {m: len(v) for m, v in splits.items()} }; cli.analyze stats {stats}; lengths "
            f"{lengths}; BucketedLoader read {loaded}")
    seconds = time.perf_counter() - t_phase
    log(f"  phase 14: {seconds:.1f} s (limit {FRONTEND_LIMIT_S:.0f} s); card {smi}")
    check(seconds <= FRONTEND_LIMIT_S, f"phase 14 took {seconds:.1f} s, over its "
          f"{FRONTEND_LIMIT_S:.0f} s limit")
    return {"native": {"compiler": cxx, "library": lib.name, "found_built": found,
                       "build_s": build_s, "max_abs_err_vs_numpy": native_errs},
            "featurize_ms_per_chain": feat_ms, "bound_contacts": bound_contacts,
            "launches": {"predict_pdb": runs["predict_pdb"][0],
                         "predict_npz": runs["predict_npz"][0],
                         "serve_pdb_per_capture": serve_counts},
            "cli_predict_pdb_wall_s": runs["predict_pdb"][1],
            "cli_predict_npz_wall_s": runs["predict_npz"][1],
            "pdb_vs_npz_bitwise": True, "map_shape": list(probs.shape),
            "pdb_to_map_ms": statistics.median(walls),
            "featurize_pair_ms": statistics.median(feats), "serve": served,
            "build_dataset_s": build_dataset_s, "splits": {m: len(v) for m, v in splits.items()},
            "analyze_stats": stats, "analyze_lengths": lengths, "loader_complexes": loaded,
            "seconds": seconds, "card": smi}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    # Phase 5b's bitwise resume check runs under deterministic algorithms,
    # which need this set before cuBLAS starts.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    watchdog = threading.Timer(SCRIPT_LIMIT_S, _overrun)
    watchdog.daemon = True
    watchdog.start()

    with phase("1"):
        smi = nvidia_smi_line()
        log("== phase 1: device and toolchain")
        log(f"  device: {name} (count {torch.cuda.device_count()}, capability "
            f"{torch.cuda.get_device_capability(0)})")
        log(f"  nvidia-smi: {smi}")
        log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}")
        nvcc = subprocess.run([cuda_attention._nvcc(), "--version"], capture_output=True,
                              text=True, check=True).stdout.strip().splitlines()
        log(f"  nvcc: {nvcc[-2] if len(nvcc) > 1 else nvcc[-1]}")
        try:
            import triton
            log(f"  triton {triton.__version__}")
        except ImportError:
            log("  triton: not importable")

    with phase("2"):
        build_kernels()
    rng = np.random.default_rng(args.seed)
    with phase("3"):
        flagship, flagship_bwd, fwd_errs, bwd_err, n768_errs, head_dims = kernel_parity(rng)

    with phase("4"):
        log("== phase 4: predict path (predict_complex, flagship width, seeded weights)")
        cfg = ModelConfig()
        set_backend_precision(cfg.gnn.compute_dtype)
        model = load_model(cfg, device, seed=args.seed)
        plain_cfg = dataclasses.replace(cfg, gnn=dataclasses.replace(cfg.gnn,
                                                                     attention_impl="plain"))
        plain_model = load_model(plain_cfg, device, seed=args.seed)
        plain_model.load_state_dict(model.state_dict())
        raws = [random_raw_complex(n1, n2, rng) for n1, n2 in COMPLEXES]
        predict_counts, logit_diffs = run_predict_path(model, plain_model, raws, device)
        bf16 = load_model(dataclasses.replace(cfg, compute_dtype="bfloat16"), device,
                          seed=args.seed)
        probs16 = predict_complex(raws[0], bf16, device)["contact_prob_map"]
        check(probs16.shape == COMPLEXES[0] and bool(np.isfinite(probs16).all()),
              "bfloat16 policy: probabilities not finite")
        log(f"  bfloat16 policy: {COMPLEXES[0][0]}x{COMPLEXES[0][1]} probs finite, "
            f"max |p_bf16 - p_f32| {np.abs(probs16 - predict_complex(raws[0], model, device)['contact_prob_map']).max():.3g}")
        del bf16

    with phase("5"):
        log("== phase 5: training path (cli.train, flagship width, one epoch)")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as root:
            write_tiny_npz_dataset(root, sizes=COMPLEXES, seed=args.seed, knn=constants.KNN,
                                   geo_nbrhd_size=constants.GEO_NBRHD_SIZE)
            train_counts, train_steps = run_train_path(root, args.seed)
            batches = list(BucketedLoader(DIPSDataset(root, "train")))
        state = create_train_state(model, seed=args.seed)
        check_step_launches(state, batches[-1])
        bn_diffs = compare_train_step("batch norm (flagship)", model, plain_model, batches[-1],
                                      args.seed, spread_seeds=(1, 2))
        ln_cfg = dataclasses.replace(cfg, gnn=dataclasses.replace(cfg.gnn, norm_type="layer"))
        ln_plain_cfg = dataclasses.replace(
            ln_cfg, gnn=dataclasses.replace(ln_cfg.gnn, attention_impl="plain"))
        ln_diffs = compare_train_step("layer norm", load_model(ln_cfg, device, seed=args.seed),
                                      load_model(ln_plain_cfg, device, seed=args.seed),
                                      batches[-1], args.seed)
        del plain_model

    with phase("5b"):
        log("== phase 5b: training lifecycle (cli.train --ckpt_dir / --resume, cli.test and "
            "predict --ckpt_name; flagship width, then DeepLab; deterministic algorithms)")
        torch.use_deterministic_algorithms(True)
        try:
            lifecycle = run_lifecycle(raws[0], args.seed, device, exact=True)
            log("  DeepLab lifecycle (--interact_module_type deeplab, two complexes):")
            lifecycle["deeplab"] = run_lifecycle(
                raws[0], args.seed, device, exact=True,
                flags=["--interact_module_type", "deeplab"], sizes=DEEPLAB_LIFECYCLE,
                save_modes=False)
        finally:
            torch.use_deterministic_algorithms(False)
        lifecycle["checkpoint"] = time_checkpoint(state)
        log("  lifecycle: " + json.dumps(lifecycle))

    with phase("6"):
        log("== phase 6: times (CUDA events; kernels median of 20, predict of "
            f"{PHASE6_PREDICT_RUNS})")
        ktimes = time_kernels(rng, flagship, flagship_bwd)
        for (n1, n2), raw in zip(COMPLEXES, raws):
            t = time_predict(model, raw, device, runs=PHASE6_PREDICT_RUNS)
            log(f"  predict {n1}x{n2}: encode x2 {t['encode_ms']:.3f} ms, decode "
                f"{t['decode_ms']:.3f} ms, predict_complex wall {t['predict_wall_ms']:.3f} ms")
        for batch in batches:
            b1, b2 = batch.contact_map.shape[1:]
            n1, n2 = int(batch.graph1.num_nodes[0]), int(batch.graph2.num_nodes[0])
            t = time_train_step(state, batch.to(device), runs=PHASE6_TRAIN_RUNS)
            log(f"  train step {n1}x{n2} (buckets {b1}/{b2}): {t['train_step_ms']:.3f} ms "
                f"(host clock, synchronized, median of {PHASE6_TRAIN_RUNS}), peak memory "
                f"{t['max_memory_allocated_gb']:.3f} GiB; split: forward+loss "
                f"{t['forward_ms']:.3f} ms, backward {t['backward_ms']:.3f} ms, optimizer "
                f"{t['optimizer_ms']:.3f} ms")
        prof = profile_train_step(state, batches[-1].to(device))
        busy = ("not measured (no device events in the trace)" if prof["device_busy_ms"] is None
                else f"{prof['device_busy_ms']:.3f} ms busy "
                     f"({100 * prof['device_busy_ms'] / prof['wall_ms']:.1f}%)")
        log(f"  train step {n1}x{n2} under torch.profiler: wall {prof['wall_ms']:.3f} ms, "
            f"{prof['kernels']} device kernels, device {busy}")

    with phase("7"):
        log("== phase 7: model configurations (flagship encoder width, seeded weights)")
        del state, model
        torch.cuda.empty_cache()
        configs = run_model_configs(cfg, raws, random_raw_complex(*TILED_COMPLEX, rng),
                                    args.seed, device, smi)
    with phase("8a"):
        remat = run_remat(cfg, args.seed, device, smi, CONFIG_RUNS["train_tiled"])
        for policy in REMAT_POLICIES:
            configs[f"train_six_tiles_remat_{policy}"] = remat[f"train_six_tiles_{policy}"]
    with phase("8b"):
        importer = run_importer(cfg, raws, args.seed, device)
    with phase("8c"):
        supervisor = run_supervisor(args.seed)
    with phase("9"):
        serving = run_serving(cfg, raws, random_raw_complex(*TILED_COMPLEX, rng), args.seed,
                              device, smi)
        serving["configs"] = run_serving_configs(cfg, raws, args.seed, device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_split_") as work:
        with phase("10"):
            screening = run_screening(cfg, args.seed, device, smi, work)
        with phase("11"):
            fleet = run_fleet_phase(cfg, args.seed, device, smi, work)
    with phase("12"):
        dispatch = run_dispatch_loop(args.seed, device, smi)
    with phase("13"):
        graphs13 = run_step_graphs(args.seed, device, smi)
    with phase("14"):
        frontend = run_frontend(args.seed, device, smi)
    with phase("summary"):
        log("  remat: " + json.dumps({k: v for k, v in remat.items()
                                      if not k.startswith("train_six")}))
        config_paths = [k for k in configs if k.startswith(("predict_", "train_"))]
        # Launches of the other counted paths: (K1, K2, CSR builds) each.
        more_paths = {**{f"{path}_deeplab": lifecycle["deeplab"]["launches"][path]
                         for path in LIFECYCLE_PATHS},
                      **{f"import_{path}": counts for path, counts in importer["launches"].items()}}

        at = ktimes["by_n"][256]
        common = {"route": "cuda", "library_ms": None, "parity": "pass",
                  "csr_build_ms": at["csr_ms"],
                  "csr_build_ms_by_n": {n: t["csr_ms"] for n, t in ktimes["by_n"].items()},
                  "csr_builds_by_path": {"predict": predict_counts[2], "train": train_counts[2],
                                         **{path: lifecycle["launches"][path][2]
                                            for path in LIFECYCLE_PATHS},
                                         **{path: configs[path]["launches"][2]
                                            for path in config_paths},
                                         **{path: c[2] for path, c in more_paths.items()},
                                         "serve_per_capture": serving["per_capture"][2],
                                         **{f"serve_{name}_per_capture": c["per_capture"][2]
                                            for name, c in serving["configs"].items()},
                                         "screen": screening["launches"][2],
                                         "screen_encode_per_capture":
                                             screening["per_encode_capture"][2],
                                         "route_screen_per_encode_capture": ENCODE_COUNTS[2],
                                         "route_assembly": fleet["routes"]["assembly"]["launches"][2],
                                         "fleet_worker_per_capture": FLEET_COUNTS[2],
                                         **{f"dispatch_{mode}": c[2]
                                            for mode, c in dispatch["launches"].items()},
                                         **{path: c[2] for path, c in frontend["launches"].items()}},
                  "phase8": {"remat": {k: v for k, v in remat.items() if k.startswith(
                                 ("tiled_two", "deeplab"))},
                             "importer": {k: v for k, v in importer.items() if k != "launches"},
                             "supervisor": {k: v for k, v in supervisor.items() if k != "record"},
                             "supervisor_restarts": supervisor["record"]["restarts"]},
                  "model_configs": {
                      "predict_max_logit_diff_vs_plain": {
                          path: configs[path]["max_logit_diff"] for path in config_paths
                          if path.startswith("predict_")},
                      "predict_max_rounding_spread": {
                          path: configs[path]["max_spread"] for path in config_paths
                          if path.startswith("predict_")},
                      "tiles_vs_direct_max_diff": {k: v for k, v in configs.items()
                                                   if k.endswith("_tiles_max_diff")},
                      "deeplab_stems_max_diff_and_spread": configs["deeplab_stems"],
                      "peak_gib": {path: (max(c["peak_gib"] for c in configs[path]["complexes"])
                                          if path.startswith("predict_")
                                          else configs[path]["max_memory_allocated_gb"])
                                   for path in config_paths}}}
        kernels = [{
            "name": "edge_attention_fwd",
            "source": "deepinteract_tpu_torch/csrc/edge_attention_fwd.cu",
            "replaces": "deepinteract_tpu/ops/pallas_attention.py:443",
            "launches": train_counts[0],
            "launches_by_path": {"predict": predict_counts[0], "train": train_counts[0],
                                 **{path: lifecycle["launches"][path][0]
                                    for path in LIFECYCLE_PATHS},
                                 **{path: configs[path]["launches"][0] for path in config_paths},
                                 **{path: c[0] for path, c in more_paths.items()},
                                 # Served: counted at each capture (the Python counter does
                                 # not run at replay), and the replays of every entry.
                                 "serve_per_capture": serving["per_capture"][0],
                                 "serve_replays": serving["replays"],
                                 **{f"serve_{name}_per_capture": c["per_capture"][0]
                                    for name, c in serving["configs"].items()},
                                 # Phase 10: counted around the screen (at each encode
                                 # capture), per encode capture, and the encode replays.
                                 "screen": screening["launches"][0],
                                 "screen_encode_per_capture": screening["per_encode_capture"][0],
                                 "screen_encode_replays": screening["encode_replays"],
                                 # Phase 11: at each encode capture of the /screen route,
                                 # around the /assembly route, and at each capture of a
                                 # fleet worker (its /stats compile_inventory).
                                 "route_screen_per_encode_capture":
                                     fleet["routes"]["route_screen_per_encode_capture"],
                                 "route_assembly": fleet["routes"]["route_assembly"],
                                 "fleet_worker_per_capture": fleet["fleet_worker_per_capture"],
                                 # Phase 12: around the inline and the prefetching run.
                                 **{f"dispatch_{mode}": c[0]
                                    for mode, c in dispatch["launches"].items()},
                                 # Phase 13: around each cli.train run (graphed: at the
                                 # captures), and in one profiled train and eval replay.
                                 **{f"step_graphs_{mode}": c[0]
                                    for mode, c in graphs13["launches"].items()},
                                 "train_replay_profiled": graphs13["profiled_train_replay"]["k1"],
                                 "eval_replay_profiled": graphs13["profiled_eval_replay"]["k1"],
                                 # Phase 14: around cli.predict from two PDB files and
                                 # from its saved npz, at the served PDB key's capture.
                                 **{path: c[0] for path, c in frontend["launches"].items()}},
            "dispatch_profile_window_k1": dispatch["trace"]["k1"],
            "screen_profiled_encode_replay_k1": screening["profiled_encode_replay"]["k1"],
            "serve_profiled_replay_k1": serving["profiled_replay"]["k1"],
            "max_abs_err": max(fwd_errs.values()), "max_abs_err_n768": n768_errs[0],
            "ms_by_head_dim": {k: t["k1_ms"] for k, t in ktimes["by_head_dim"].items()},
            "bound_ms_by_head_dim": {k: t["k1_bound_ms"] for k, t in ktimes["by_head_dim"].items()},
            "max_abs_err_head_dims": {dt: e["k1"] for dt, e in head_dims.items()},
            "ms": at["k1_ms"], "plain_ms": ktimes["k1_plain_ms"], "bound_ms": at["k1_bound_ms"],
            "bound_by": at["k1_bound_by"], "host_ms": at["k1_host_ms"],
            "ms_by_n": {n: t["k1_ms"] for n, t in ktimes["by_n"].items()},
            "bound_ms_by_n": {n: t["k1_bound_ms"] for n, t in ktimes["by_n"].items()},
            "max_abs_logit_diff_vs_plain": max(logit_diffs), **common,
        }, {
            "name": "edge_attention_bwd",
            "source": "deepinteract_tpu_torch/csrc/edge_attention_bwd.cu",
            "replaces": "deepinteract_tpu/ops/pallas_attention.py:519",
            "launches": train_counts[1],
            "launches_by_path": {"predict": predict_counts[1], "train": train_counts[1],
                                 **{path: lifecycle["launches"][path][1]
                                    for path in LIFECYCLE_PATHS},
                                 **{path: configs[path]["launches"][1] for path in config_paths},
                                 **{path: c[1] for path, c in more_paths.items()},
                                 "serve_per_capture": serving["per_capture"][1],
                                 **{f"serve_{name}_per_capture": c["per_capture"][1]
                                    for name, c in serving["configs"].items()},
                                 "screen": screening["launches"][1],
                                 "screen_encode_per_capture": screening["per_encode_capture"][1],
                                 "route_screen_per_encode_capture": ENCODE_COUNTS[1],
                                 "route_assembly": fleet["routes"]["assembly"]["launches"][1],
                                 "fleet_worker_per_capture": FLEET_COUNTS[1],
                                 **{f"dispatch_{mode}": c[1]
                                    for mode, c in dispatch["launches"].items()},
                                 **{f"step_graphs_{mode}": c[1]
                                    for mode, c in graphs13["launches"].items()},
                                 "train_replay_profiled": graphs13["profiled_train_replay"]["k2"],
                                 "eval_replay_profiled": graphs13["profiled_eval_replay"]["k2"],
                                 **{path: c[1] for path, c in frontend["launches"].items()}},
            "dispatch_profile_window_k2": dispatch["trace"]["k2"],
            "max_abs_err": bwd_err, "max_abs_err_n768": n768_errs[1],
            "ms_by_head_dim": {k: t["k2_ms"] for k, t in ktimes["by_head_dim"].items()},
            "bound_ms_by_head_dim": {k: t["k2_bound_ms"] for k, t in ktimes["by_head_dim"].items()},
            "max_abs_err_head_dims": {dt: e["k2"] for dt, e in head_dims.items()},
            "function_max_abs_err_head_dims": {dt: e["function"] for dt, e in head_dims.items()},
            "ms": at["k2_ms"], "plain_ms": ktimes["k2_plain_ms"], "bound_ms": at["k2_bound_ms"],
            "bound_by": at["k2_bound_by"], "host_ms": at["k2_host_ms"],
            "ms_by_n": {n: t["k2_ms"] for n, t in ktimes["by_n"].items()},
            "bound_ms_by_n": {n: t["k2_bound_ms"] for n, t in ktimes["by_n"].items()},
            "train_steps": train_steps,
            "train_step_vs_plain": {
                "batch_norm": dict(zip(("loss_diff", "max_grad_diff", "max_grad_spread"), bn_diffs)),
                "layer_norm": dict(zip(("loss_diff", "max_grad_diff"), ln_diffs[:2]))},
            **common,
        }]
        print(json.dumps({"serving": serving}), flush=True)
        print(json.dumps({"screening": screening}), flush=True)
        print(json.dumps({"fleet": fleet}), flush=True)
        print(json.dumps({"step_graphs": graphs13}), flush=True)
        print(json.dumps({"dispatch": dispatch}), flush=True)
        print(json.dumps({"frontend": frontend}), flush=True)
        print(json.dumps({"kernels": kernels}), flush=True)
        print(nvidia_smi_line(), flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                                 "count": torch.cuda.device_count()}}), flush=True)
    watchdog.cancel()
    return 0


if __name__ == "__main__":
    sys.exit(main())
