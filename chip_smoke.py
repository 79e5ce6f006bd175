"""Chip smoke run of the PyTorch/CUDA port (``deepinteract_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero:
  1. device and toolchain (card, power limit, CUDA, nvcc, triton);
  2. build of every hand-written kernel from the sources in this checkout;
  3. kernel parity on the card: each kernel's wrapper against its plain
     PyTorch version at the main path's shapes, outputs pre-filled with NaN;
  4. the main path: ``cli.predict.predict_complex`` at the flagship width
     (2-layer GT, hidden 128, 4 heads, kNN 20; 14-chunk dilated decoder of
     128 channels; seeded random weights) on three synthetic complexes,
     with the kernel launch counts read around it, and the same model with
     the plain attention compared on logits;
  5. times with CUDA events (warm-up, median of >= 20 runs): each kernel
     and its plain version, and predict per complex split into encode and
     decode.
The line before the last is the card's name and power limit; before it, a
``{"kernels": [...]}`` JSON line. The last line is the device record
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 1 and
prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from deepinteract_tpu_torch.cli.predict import load_model, predict_complex
from deepinteract_tpu_torch.data import features
from deepinteract_tpu_torch.data.graph import pad_graph, stack_complexes
from deepinteract_tpu_torch.data.io import to_paired_complex
from deepinteract_tpu_torch.data.synthetic import (random_backbone, random_raw_complex,
                                                   random_residue_feats)
from deepinteract_tpu_torch.models.model import ModelConfig
from deepinteract_tpu_torch.models.policy import set_backend_precision
from deepinteract_tpu_torch.ops import cuda_attention
from deepinteract_tpu_torch.ops.attention import edge_attention_forward as plain_forward

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # H100 SXM data sheet: float32 outside the tensor cores
COMPLEXES = ((100, 80), (200, 180), (60, 250))  # -> buckets 128/128, 256/192, 64/256
LAUNCHES_PER_PREDICT = 4  # 2 GT layers x 2 siamese encodes


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


# ---------------------------------------------------------------------------
# Phase 3: kernel parity
# ---------------------------------------------------------------------------


def attention_case(rng, batch, n_real, n_pad, knn, heads, head_dim, dtype, orphan=None,
                   device="cuda"):
    """Attention inputs on the card over real kNN graphs with a padded tail;
    ``orphan`` names a node of graph 0 left without in-edges."""
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
    dev = torch.device(device)
    shape = (batch, n_pad, heads, head_dim)
    qkv = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
           for _ in range(3)]
    pe = torch.from_numpy(rng.standard_normal((batch, n_pad, knn, heads, head_dim))
                          .astype(np.float32)).to(dev, dtype)
    return (*qkv, pe, nbr.to(dev).contiguous(), torch.stack(masks).float().to(dev).contiguous())


def check_attention(name, args, tol, orphan=None) -> dict:
    q = args[0]
    b, n, h, d = q.shape
    kk = args[4].shape[-1]
    out = (torch.full((b, n, h, d), float("nan"), device=q.device),
           torch.full((b, n, kk, h, d), float("nan"), device=q.device, dtype=q.dtype),
           torch.full((b, n, h * d), float("nan"), device=q.device))
    got = cuda_attention.edge_attention_forward(*args, out=out)
    ref = plain_forward(*args)
    errs = {}
    for label, g, r in zip(("h", "e_out", "z"), got, ref):
        check(not torch.isnan(g).any(), f"{name}: {label} has unwritten (NaN) elements")
        g, r = g.float(), r.float()
        errs[label] = (g - r).abs().max().item()
        check(torch.allclose(g, r, rtol=tol, atol=tol),
              f"{name}: {label} differs from the plain version by {errs[label]:.3g} (tol {tol})")
    if orphan is not None:
        check(bool((got[0][0, orphan] == 0).all()), f"{name}: node without in-edges has h != 0")
    log(f"  {name}: max |kernel - plain| h {errs['h']:.3g}  e_out {errs['e_out']:.3g}  "
        f"z {errs['z']:.3g}  (tol {tol})")
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
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    log(f"  bound: {nbytes} B -> {bytes_ms:.5f} ms; {ops} float32 ops -> {ops_ms:.5f} ms")
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


# ---------------------------------------------------------------------------
# Phase 4 and 5: main path
# ---------------------------------------------------------------------------


def run_main_path(model, plain_model, raws, device):
    launches = []
    results = []
    cuda_attention.edge_attention_forward.launches = 0
    for raw in raws:
        before = cuda_attention.edge_attention_forward.launches
        results.append(predict_complex(raw, model, device))
        launches.append(cuda_attention.edge_attention_forward.launches - before)
    total = cuda_attention.edge_attention_forward.launches
    for (n1, n2), res, count in zip(COMPLEXES, results, launches):
        probs = res["contact_prob_map"]
        check(count == LAUNCHES_PER_PREDICT,
              f"complex {n1}x{n2}: {count} kernel launches, expected {LAUNCHES_PER_PREDICT}")
        check(probs.shape == (n1, n2), f"complex {n1}x{n2}: probs shape {probs.shape}")
        check(bool(np.isfinite(probs).all()) and probs.min() >= 0 and probs.max() <= 1,
              f"complex {n1}x{n2}: probabilities not finite in [0, 1]")
    diffs = []
    for (n1, n2), raw, res in zip(COMPLEXES, raws, results):
        plain = predict_complex(raw, plain_model, device)["logits"]
        diff = float(np.abs(plain - res["logits"]).max())
        diffs.append(diff)
        check(np.allclose(res["logits"], plain, rtol=1e-4, atol=1e-4),
              f"complex {n1}x{n2}: kernel vs plain logits differ by {diff:.3g}")
        log(f"  {n1}x{n2}: launches {LAUNCHES_PER_PREDICT}, probs in "
            f"[{res['contact_prob_map'].min():.4f}, {res['contact_prob_map'].max():.4f}], "
            f"max |logits kernel - plain| {diff:.3g}")
    check(cuda_attention.edge_attention_forward.launches == total,
          "the plain-attention model launched the kernel")
    return total, diffs


def time_predict(model, raw, device) -> dict:
    """Encode (both chains) and decode ms from CUDA events, and the whole
    predict_complex call (host to host) from the wall clock."""
    cx = stack_complexes([to_paired_complex(raw)]).to(device)
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

    log("== phase 2: build")
    built = cuda_attention.build()
    log(f"  edge_attention_fwd: {built['seconds']:.2f} s -> {built['path']}")
    for line in built["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"    {line.strip()}")

    log("== phase 3: kernel parity on the card")
    rng = np.random.default_rng(args.seed)
    flagship = attention_case(rng, 1, 200, 256, 20, 4, 32, torch.float32)
    errs = check_attention("flagship f32 (B=1 N=256/200 K=20 H=4 D=32)", flagship, 1e-5)
    check_attention("flagship bf16", tuple(t.to(torch.bfloat16) if t.is_floating_point()
                                           and t.dim() >= 4 else t for t in flagship), 3e-2)
    check_attention("B=2 N=64/50 D=8 with an orphan node",
                    attention_case(rng, 2, 50, 64, 20, 4, 8, torch.float32, orphan=3), 1e-5,
                    orphan=3)

    log("== phase 4: main path (predict_complex, flagship width, seeded weights)")
    cfg = ModelConfig()
    set_backend_precision(cfg.gnn.compute_dtype)
    model = load_model(cfg, device, seed=args.seed)
    plain_cfg = dataclasses.replace(cfg, gnn=dataclasses.replace(cfg.gnn, attention_impl="plain"))
    plain_model = load_model(plain_cfg, device, seed=args.seed)
    plain_model.load_state_dict(model.state_dict())
    raws = [random_raw_complex(n1, n2, rng) for n1, n2 in COMPLEXES]
    launches, logit_diffs = run_main_path(model, plain_model, raws, device)
    bf16 = load_model(dataclasses.replace(cfg, compute_dtype="bfloat16"), device, seed=args.seed)
    probs16 = predict_complex(raws[0], bf16, device)["contact_prob_map"]
    check(probs16.shape == COMPLEXES[0] and bool(np.isfinite(probs16).all()),
          "bfloat16 policy: probabilities not finite")
    log(f"  bfloat16 policy: {COMPLEXES[0][0]}x{COMPLEXES[0][1]} probs finite, "
        f"max |p_bf16 - p_f32| {np.abs(probs16 - predict_complex(raws[0], model, device)['contact_prob_map']).max():.3g}")

    log("== phase 5: times (CUDA events, median of 20)")
    with torch.inference_mode():
        out = cuda_attention.edge_attention_forward(*flagship)
        kernel_ms = time_ms(lambda: cuda_attention.edge_attention_forward(*flagship),
                            runs=20, inner=20)
        plain_ms = time_ms(lambda: plain_forward(*flagship), runs=20, inner=5)
    bound_ms, bound_by = attention_bound(flagship, out)
    log(f"  edge_attention_fwd flagship f32: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.5f} ms ({bound_by})")
    for (n1, n2), raw in zip(COMPLEXES, raws):
        t = time_predict(model, raw, device)
        log(f"  predict {n1}x{n2}: encode x2 {t['encode_ms']:.3f} ms, decode "
            f"{t['decode_ms']:.3f} ms, predict_complex wall {t['predict_wall_ms']:.3f} ms")

    kernels = [{
        "name": "edge_attention_fwd", "route": "cuda",
        "source": "deepinteract_tpu_torch/csrc/edge_attention_fwd.cu",
        "replaces": "deepinteract_tpu/ops/pallas_attention.py:443",
        "launches": launches, "max_abs_err": max(errs.values()),
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "parity": "pass",
        "max_abs_logit_diff_vs_plain": max(logit_diffs),
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
