"""Chip smoke run of the PyTorch/CUDA port (``deepinteract_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero:
  1. device and toolchain (card, power limit, CUDA, nvcc, triton);
  2. build of every hand-written kernel from the sources in this checkout
     (one nvcc per source, started together);
  3. kernel parity on the card: the in-edge CSR against a CPU stable
     argsort; each kernel's wrapper against its plain PyTorch version at
     the main paths' shapes (flagship f32 and bf16, de=None, a hub
     destination with over 1,000 in-edges, the N=512 bucket, a node
     without in-edges, rows wider than a warp, an odd head count),
     outputs pre-filled with NaN, and two calls bitwise equal; the
     edge-attention autograd Function (K1 forward, K2 backward) against
     autograd through the plain forward;
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
  6. times with CUDA events (warm-up, median of >= 20 runs): each kernel
     (on a prebuilt CSR, as the main path runs it) and the CSR build at
     N = 64, 128, 192, 256 and 512 beside each kernel's bound, the plain
     versions at N = 256; predict per complex split into encode and
     decode; the train step per complex (host clock around synchronized
     steps, median of 10) with its peak memory and its split into
     forward, backward and optimizer; one step of the largest complex
     under torch.profiler for its kernel count and device busy share.
The line before the last is the card's name and power limit; before it, a
``{"kernels": [...]}`` JSON line. The last line is the device record
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 1 and
prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from deepinteract_tpu_torch import constants
from deepinteract_tpu_torch.cli import train as train_cli
from deepinteract_tpu_torch.cli.predict import load_model, predict_complex
from deepinteract_tpu_torch.data import features
from deepinteract_tpu_torch.data.datasets import DIPSDataset
from deepinteract_tpu_torch.data.graph import pad_graph, stack_complexes
from deepinteract_tpu_torch.data.io import to_paired_complex
from deepinteract_tpu_torch.data.loader import BucketedLoader
from deepinteract_tpu_torch.data.synthetic import (random_backbone, random_raw_complex,
                                                   random_residue_feats,
                                                   write_tiny_npz_dataset)
from deepinteract_tpu_torch.models.layers import dropout_rng
from deepinteract_tpu_torch.models.model import ModelConfig
from deepinteract_tpu_torch.models.policy import set_backend_precision
from deepinteract_tpu_torch.ops import attention as plain
from deepinteract_tpu_torch.ops import cuda_attention
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
TIMED_N = {64: 50, 128: 100, 192: 180, 256: 200, 512: 450}  # bucket -> real nodes


def log(msg: str) -> None:
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


def kernel_parity(rng, device="cuda"):
    """Phase 3 (on CPU tensors with ``device="cpu"``, a rehearsal of the
    wrappers' plain versions). Returns (flagship inputs, their K2 inputs, K1's errors at
    the flagship, K2's largest error there)."""
    log("== phase 3: kernel parity on the card")
    f32 = torch.float32
    flagship = attention_case(rng, 1, 200, 256, 20, 4, 32, f32, device=device)
    hub = attention_case(rng, 1, 200, 256, 20, 4, 32, f32, hub=(5, 64), device=device)
    n512 = attention_case(rng, 1, 450, 512, 20, 4, 32, f32, device=device)
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
             ("B=2 N=64/50 D=8 with an orphan node", orphan, 3),
             ("H*D=1024 (B=1 N=128/100 H=32 D=32)", wide, None),
             ("H*D=1024 bf16", to_bf16(wide), None),
             ("3 heads (B=2 N=64/50 H=3 D=16)", odd, None))
    bf16 = lambda args: args[0].dtype == torch.bfloat16  # noqa: E731
    fwd_errs = [check_attention(name, args, 3e-2 if bf16(args) else 1e-5, orphan=orph)
                for name, args, orph in cases][0]
    flagship_bwd = backward_case(rng, flagship)
    bwd_err = check_backward("flagship f32", flagship_bwd, 1e-4)
    check_backward("flagship f32, de=None", backward_case(rng, flagship, with_de=False), 1e-4)
    for name, args, orph in cases[1:]:
        check_backward(name, backward_case(rng, args), 3e-2 if bf16(args) else 1e-4,
                       orphan=orph)
    check_autograd("flagship f32", flagship, 1e-4)
    check_autograd("flagship f32, e_out unused", flagship, 1e-4, with_de=False)
    check_autograd("flagship bf16", to_bf16(flagship), 3e-2)
    return flagship, flagship_bwd, fwd_errs, bwd_err


def time_kernels(rng, flagship, flagship_bwd) -> dict:
    """K1, K2 (with de) and the CSR build at B=1, K=20, H*D=128 f32 for
    each bucket N of TIMED_N (N=256: the flagship case), each kernel on a
    prebuilt CSR as the main path runs it, beside its bound; the plain
    versions at N=256."""
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
    return {"by_n": by_n, "k1_plain_ms": k1_plain, "k2_plain_ms": k2_plain}


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


def time_predict(model, raw, device) -> dict:
    """Encode (both chains) and decode ms from CUDA events, and the whole
    predict_complex call (host to host) from the wall clock."""
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

        enc = time_ms(encode)
        dec = time_ms(decode)
    walls = []
    for _ in range(20):
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
                                 "--log_every", "1"])
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


def time_train_step(state, batch, runs: int = 10) -> dict:
    """Train step ms (forward + backward + optimizer, host clock around
    synchronized steps, median of ``runs``), its peak device memory, and
    the same step split at synchronize points into the train-mode forward
    with the loss, the backward, and the optimizer update (medians)."""
    for _ in range(2):
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
    for _ in range(runs):
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
            **{k: statistics.median(v) for k, v in phases.items()}}


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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
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
    flagship, flagship_bwd, fwd_errs, bwd_err = kernel_parity(rng)

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

    log("== phase 6: times (CUDA events, median of 20)")
    ktimes = time_kernels(rng, flagship, flagship_bwd)
    for (n1, n2), raw in zip(COMPLEXES, raws):
        t = time_predict(model, raw, device)
        log(f"  predict {n1}x{n2}: encode x2 {t['encode_ms']:.3f} ms, decode "
            f"{t['decode_ms']:.3f} ms, predict_complex wall {t['predict_wall_ms']:.3f} ms")
    for batch in batches:
        b1, b2 = batch.contact_map.shape[1:]
        n1, n2 = int(batch.graph1.num_nodes[0]), int(batch.graph2.num_nodes[0])
        t = time_train_step(state, batch.to(device))
        log(f"  train step {n1}x{n2} (buckets {b1}/{b2}): {t['train_step_ms']:.3f} ms "
            f"(host clock, synchronized, median of 10), peak memory "
            f"{t['max_memory_allocated_gb']:.3f} GiB; split: forward+loss "
            f"{t['forward_ms']:.3f} ms, backward {t['backward_ms']:.3f} ms, optimizer "
            f"{t['optimizer_ms']:.3f} ms")
    prof = profile_train_step(state, batches[-1].to(device))
    busy = ("not measured (no device events in the trace)" if prof["device_busy_ms"] is None
            else f"{prof['device_busy_ms']:.3f} ms busy "
                 f"({100 * prof['device_busy_ms'] / prof['wall_ms']:.1f}%)")
    log(f"  train step {n1}x{n2} under torch.profiler: wall {prof['wall_ms']:.3f} ms, "
        f"{prof['kernels']} device kernels, device {busy}")

    at = ktimes["by_n"][256]
    common = {"route": "cuda", "library_ms": None, "parity": "pass",
              "csr_build_ms": at["csr_ms"],
              "csr_build_ms_by_n": {n: t["csr_ms"] for n, t in ktimes["by_n"].items()},
              "csr_builds_by_path": {"predict": predict_counts[2], "train": train_counts[2]}}
    kernels = [{
        "name": "edge_attention_fwd",
        "source": "deepinteract_tpu_torch/csrc/edge_attention_fwd.cu",
        "replaces": "deepinteract_tpu/ops/pallas_attention.py:443",
        "launches": train_counts[0],
        "launches_by_path": {"predict": predict_counts[0], "train": train_counts[0]},
        "max_abs_err": max(fwd_errs.values()),
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
        "launches_by_path": {"predict": predict_counts[1], "train": train_counts[1]},
        "max_abs_err": bwd_err,
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
