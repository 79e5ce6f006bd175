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
     decode; the train step per complex (host clock around synchronized
     steps, median of 10) with its peak memory and its split into
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
     an unsupervised run of the same command.
The line before the last is the card's name and power limit; before it, a
``{"kernels": [...]}`` JSON line. The last line is the device record
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 1 and
prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

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
from deepinteract_tpu_torch.models.layers import dropout_rng
from deepinteract_tpu_torch.models.model import ModelConfig
from deepinteract_tpu_torch.models.stem import PairFactors
from deepinteract_tpu_torch.models.policy import set_backend_precision
from deepinteract_tpu_torch.ops import attention as plain
from deepinteract_tpu_torch.ops import cuda_attention
from deepinteract_tpu_torch.robustness import artifacts, faults
from deepinteract_tpu_torch.training.checkpoint import PAYLOAD, CheckpointConfig, Checkpointer
from deepinteract_tpu_torch.training.loop import Trainer, host_snapshot, read_sidecar
from deepinteract_tpu_torch.training.objective import contact_loss
from deepinteract_tpu_torch.training.steps import (create_train_state, dropout_generator,
                                                   eval_step, loss_and_grads, train_step)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # H100 SXM data sheet: float32 outside the tensor cores
COMPLEXES = ((100, 80), (200, 180), (60, 250))  # -> buckets 128/128, 256/192, 64/256
LAUNCHES_PER_ENCODE_PAIR = 4  # 2 GT layers x 2 siamese encodes
BUILDS_PER_ENCODE_PAIR = 2  # one in-edge CSR per encode
# Counted around the main paths: K1 launches, K2 launches, CSR builds.
COUNTERS = (cuda_attention.edge_attention_forward, cuda_attention.edge_attention_backward)
TIMED_N = {64: 50, 128: 100, 192: 180, 256: 200, 512: 450, 768: 600}  # bucket -> real nodes


T0 = time.perf_counter()


def log(msg: str) -> None:
    if msg.startswith("== "):  # a phase header: with the seconds since the start
        msg = f"{msg} [t = {time.perf_counter() - T0:.1f} s]"
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


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
    evals = len(DIPSDataset(root, "val")) + len(DIPSDataset(root, "test"))
    expected = (LAUNCHES_PER_ENCODE_PAIR * (steps + evals), LAUNCHES_PER_ENCODE_PAIR * steps,
                BUILDS_PER_ENCODE_PAIR * (steps + evals))
    check(steps == len(COMPLEXES), f"train: {steps} steps, expected {len(COMPLEXES)}")
    check(counts == expected, f"train: (K1, K2 launches, CSR builds) {counts}, expected "
          f"{expected} ({steps} train steps, {evals} eval complexes)")
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
        loss = loss_and_grads(m, batch, False, dropout_generator(seed, 0, batch.contact_map.device))
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
    model, device = state.model, batch.contact_map.device
    phases = {"forward_ms": [], "backward_ms": [], "optimizer_ms": []}
    for _ in range(runs if split else 0):
        t0 = time.perf_counter()
        model.train()
        model.zero_grad(set_to_none=True)
        with dropout_rng(model, dropout_generator(state.seed, state.step, device)):
            loss = contact_loss(model(batch.graph1, batch.graph2), batch.contact_map,
                                batch.pair_mask)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        state.optimizer.update()
        state.step += 1
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


def _train_argv(root, ckpt_dir, seed, *extra):
    return ["--dips_root", root, "--num_epochs", str(LIFECYCLE_EPOCHS), "--seed", str(seed),
            "--log_every", "0", "--ckpt_dir", ckpt_dir, *extra]


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
        n_train, n_val, n_test = (len(DIPSDataset(root, m)) for m in ("train", "val", "test"))
        preempt_at = n_train + 2
        modes = ("epoch_saves", "sync_epoch_saves") if save_modes else ()
        dirs = {name: os.path.join(work, name) for name in ("whole", "preempted", *modes)}

        # The uninterrupted run, with a save after every step.
        (hist_a, test_a), counts_a = train(dirs["whole"], "--save_every_steps", "1")
        _expect_launches("cli.train 2 epochs", counts_a,
                         LIFECYCLE_EPOCHS * (n_train + n_val) + n_test, LIFECYCLE_EPOCHS * n_train)
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
        _expect_launches("resumed cli.train", counts_resume, remaining + n_val + n_test, remaining)

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
        _expect_launches("cli.test", counts_test, n_test, 0)
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
        evals = len(DIPSDataset(root, "val")) + len(DIPSDataset(root, "test"))
        check(steps == len(sizes), f"train {name}: {steps} steps, expected {len(sizes)}")
        _expect_launches(f"train {name}", counts, steps + evals, steps)
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
# train step, the tiled train step. Cut from 20 / 5 / 5 / 3 in PR 6 to keep
# the script near 400 s after phase 8 joined it.
CONFIG_RUNS = {"predict": 5, "predict_tiled": 3, "train": 3, "train_tiled": 2}


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
            loss = loss_and_grads(m, batch, False, dropout_generator(seed, 0, device))
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
        _expect_launches("cli.test --ckpt_name <file.ckpt>", counts_test, 1, 0)
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
        _expect_launches("cli.train --fine_tune --ckpt_name <imported>", counts_ft, 3, 1)
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
    Popen (text pipes)."""
    env = {k: v for k, v in os.environ.items() if k != "DI_FAULTS"}
    if faults_plan:
        env["DI_FAULTS"] = faults_plan
    return subprocess.Popen(
        [sys.executable, "-m", "deepinteract_tpu_torch.cli.train", "--dips_root", root,
         "--num_epochs", "1", "--seed", str(seed), "--log_every", "0", "--ckpt_dir",
         ckpt_dir, "--save_every_steps", "1", "--deterministic", "--test_csv",
         ckpt_dir + "_top.csv", *flags, *extra],
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

    build_kernels()
    rng = np.random.default_rng(args.seed)
    flagship, flagship_bwd, fwd_errs, bwd_err, n768_errs, head_dims = kernel_parity(rng)

    log("== phase 4: predict path (predict_complex, flagship width, seeded weights)")
    cfg = ModelConfig()
    set_backend_precision(cfg.gnn.compute_dtype)
    model = load_model(cfg, device, seed=args.seed)
    plain_cfg = dataclasses.replace(cfg, gnn=dataclasses.replace(cfg.gnn, attention_impl="plain"))
    plain_model = load_model(plain_cfg, device, seed=args.seed)
    plain_model.load_state_dict(model.state_dict())
    raws = [random_raw_complex(n1, n2, rng) for n1, n2 in COMPLEXES]
    predict_counts, logit_diffs = run_predict_path(model, plain_model, raws, device)
    bf16 = load_model(dataclasses.replace(cfg, compute_dtype="bfloat16"), device, seed=args.seed)
    probs16 = predict_complex(raws[0], bf16, device)["contact_prob_map"]
    check(probs16.shape == COMPLEXES[0] and bool(np.isfinite(probs16).all()),
          "bfloat16 policy: probabilities not finite")
    log(f"  bfloat16 policy: {COMPLEXES[0][0]}x{COMPLEXES[0][1]} probs finite, "
        f"max |p_bf16 - p_f32| {np.abs(probs16 - predict_complex(raws[0], model, device)['contact_prob_map']).max():.3g}")
    del bf16

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

    log("== phase 5b: training lifecycle (cli.train --ckpt_dir / --resume, cli.test and "
        "predict --ckpt_name; flagship width, then DeepLab; deterministic algorithms)")
    torch.use_deterministic_algorithms(True)
    try:
        lifecycle = run_lifecycle(raws[0], args.seed, device, exact=True)
        log("  DeepLab lifecycle (--interact_module_type deeplab, two complexes):")
        lifecycle["deeplab"] = run_lifecycle(
            raws[0], args.seed, device, exact=True, flags=["--interact_module_type", "deeplab"],
            sizes=DEEPLAB_LIFECYCLE, save_modes=False)
    finally:
        torch.use_deterministic_algorithms(False)
    lifecycle["checkpoint"] = time_checkpoint(state)
    log("  lifecycle: " + json.dumps(lifecycle))

    log("== phase 6: times (CUDA events, median of 20)")
    ktimes = time_kernels(rng, flagship, flagship_bwd)
    for (n1, n2), raw in zip(COMPLEXES, raws):
        t = time_predict(model, raw, device)
        log(f"  predict {n1}x{n2}: encode x2 {t['encode_ms']:.3f} ms, decode "
            f"{t['decode_ms']:.3f} ms, predict_complex wall {t['predict_wall_ms']:.3f} ms")
    for batch in batches:
        b1, b2 = batch.contact_map.shape[1:]
        n1, n2 = int(batch.graph1.num_nodes[0]), int(batch.graph2.num_nodes[0])
        t = time_train_step(state, batch.to(device), runs=5)
        log(f"  train step {n1}x{n2} (buckets {b1}/{b2}): {t['train_step_ms']:.3f} ms "
            f"(host clock, synchronized, median of 5), peak memory "
            f"{t['max_memory_allocated_gb']:.3f} GiB; split: forward+loss "
            f"{t['forward_ms']:.3f} ms, backward {t['backward_ms']:.3f} ms, optimizer "
            f"{t['optimizer_ms']:.3f} ms")
    prof = profile_train_step(state, batches[-1].to(device))
    busy = ("not measured (no device events in the trace)" if prof["device_busy_ms"] is None
            else f"{prof['device_busy_ms']:.3f} ms busy "
                 f"({100 * prof['device_busy_ms'] / prof['wall_ms']:.1f}%)")
    log(f"  train step {n1}x{n2} under torch.profiler: wall {prof['wall_ms']:.3f} ms, "
        f"{prof['kernels']} device kernels, device {busy}")

    log("== phase 7: model configurations (flagship encoder width, seeded weights)")
    del state, model
    torch.cuda.empty_cache()
    configs = run_model_configs(cfg, raws, random_raw_complex(*TILED_COMPLEX, rng), args.seed,
                                device, smi)
    remat = run_remat(cfg, args.seed, device, smi, CONFIG_RUNS["train_tiled"])
    for policy in REMAT_POLICIES:
        configs[f"train_six_tiles_remat_{policy}"] = remat[f"train_six_tiles_{policy}"]
    importer = run_importer(cfg, raws, args.seed, device)
    supervisor = run_supervisor(args.seed)
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
                                     **{path: c[2] for path, c in more_paths.items()}},
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
                             **{path: c[0] for path, c in more_paths.items()}},
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
                             **{path: c[1] for path, c in more_paths.items()}},
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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
