"""Serving's mesh placement on several GPUs against one GPU: does a
``cli.serve --mesh_shape DxP`` worker answer what a one-card worker does?

    python3 serve_mesh_check.py [--cards 4] [--log_dir DIR] [-- EXTRA CLI.SERVE FLAGS]

At the flagship width with seeded weights (``--seed 0``, the same in every
worker), ``cli.serve`` workers one after another: ``one`` (one card, no
mesh; the reference), then ``4x1``, ``1x4`` and ``2x2`` (a group of D*P
processes, one per card), or with ``--cards 1`` a group of one
(``--shard_pair_map``). Each worker warms 128x128 at 1, 2, 4 and 8 slots
and the 768x512 and 1024x1024 buckets at one (``--warmup_buckets``; its
start-to-warm seconds are from its start to its ``serving on`` line),
then answers, warm:

* 32 128x128 requests from 16 concurrent clients (``--max_batch 8``):
  coalesced throughput, complexes a second over the second of two rounds;
* one 600x450 complex (768x512: six tiles) and one 1000x900 (1024x1024:
  16 tiles), each three times in a row: served latency, the median; on a
  pair axis both take the ``pair`` placement (``--pair_shard_threshold
  512``);
* a ``/screen`` of 16 chains (8 complexes, 120 pairs).

Every map and screen record is held against the one-card worker's
(largest difference printed, bar 1e-4), and each worker's ``/healthz``
mesh, labels and placements are checked. Prints each worker's numbers,
one JSON line of them all, then the cards' names and power limits; exits
1 on any failure. Each worker's output goes to ``DIR/<worker>.log``. With
``-- --device cpu`` and small-model flags it rehearses on the CPU over
gloo.
"""

from __future__ import annotations

import argparse
import http.client
import io
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

SHAPES = ("4x1", "1x4", "2x2")
WARMUP = "128x128x1,128x128x2,128x128x4,128x128x8,600x450x1,1000x900x1"
COALESCED, CLIENTS, LATENCY_RUNS = 32, 16, 3
BIG = ((600, 450), (1000, 900))
SCREEN_SIZES = ((40, 60), (90, 120), (150, 180), (200, 250), (64, 100), (128, 160),
                (192, 230), (250, 70))
BAR = 1e-4
START_TIMEOUT_S, REQUEST_TIMEOUT_S = 900.0, 600.0


class Worker:
    """One ``cli.serve`` worker; its output goes to a log file and is
    scanned for the ``serving on`` line."""

    def __init__(self, argv, log_path):
        self.t0 = time.perf_counter()
        self.log_path = log_path
        self.proc = subprocess.Popen([sys.executable, "-m", "deepinteract_tpu_torch.cli.serve",
                                      *argv], cwd=HERE, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        self.port, self.warm_s = None, None
        self._up = threading.Event()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        with open(self.log_path, "w") as log:
            for line in self.proc.stdout:
                log.write(line)
                log.flush()
                if line.startswith("serving on") and self.port is None:
                    self.warm_s = time.perf_counter() - self.t0
                    self.port = int(line.split(":")[2].split()[0])
                    self._up.set()
        self._up.set()

    def wait_up(self):
        if not self._up.wait(START_TIMEOUT_S) or self.port is None:
            raise RuntimeError(f"worker never served (rc {self.proc.poll()}; "
                               f"{self.log_path})")

    def request(self, method, path, body=None, content_type="application/json"):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=REQUEST_TIMEOUT_S)
        try:
            conn.request(method, path, body=body, headers={"Content-Type": content_type})
            resp = conn.getresponse()
            out = json.loads(resp.read())
        finally:
            conn.close()
        if resp.status != 200:
            raise RuntimeError(f"{method} {path}: {resp.status} {out}")
        return out

    def predict(self, body: bytes):
        return self.request("POST", "/predict", body, "application/octet-stream")

    def stop(self) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(120)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            return self.proc.wait()


def _npz(raw) -> bytes:
    from deepinteract_tpu_torch.data.io import save_complex_npz

    buf = io.BytesIO()
    save_complex_npz(buf, raw["graph1"], raw["graph2"], raw["examples"], "c")
    return buf.getvalue()


def _map(out):
    import numpy as np

    return np.asarray(out["contact_probs"], dtype=np.float32)


def run_worker(name, argv, log_dir, bodies, screen_payload):
    """Start one worker, measure and collect its answers, drain it."""
    worker = Worker(argv, os.path.join(log_dir, f"{name}.log"))
    try:
        worker.wait_up()
        health = worker.request("GET", "/healthz")
        small = bodies["small"]
        with ThreadPoolExecutor(max_workers=CLIENTS) as pool:
            list(pool.map(worker.predict, small))  # any cold key captured here
            t0 = time.perf_counter()
            small_out = list(pool.map(worker.predict, small))
            coalesced_s = time.perf_counter() - t0
        big = {}
        for label, body in bodies["big"].items():
            outs, walls = [], []
            for _ in range(1 + LATENCY_RUNS):
                t0 = time.perf_counter()
                outs.append(worker.predict(body))
                walls.append((time.perf_counter() - t0) * 1e3)
            big[label] = {"out": outs[-1], "served_ms": statistics.median(walls[1:]),
                          "first_ms": walls[0]}
        t0 = time.perf_counter()
        screen = worker.request("POST", "/screen", json.dumps(screen_payload).encode())
        screen_s = time.perf_counter() - t0
        stats = worker.request("GET", "/stats")["engine"]
    finally:
        rc = worker.stop()
    return {"health": health, "small": small_out, "big": big, "screen": screen,
            "stats": stats, "rc": rc, "start_to_warm_s": worker.warm_s,
            "coalesced_s": coalesced_s, "coalesced_per_s": COALESCED / coalesced_s,
            "screen_s": screen_s}


def compare(res, ref) -> dict:
    """Largest |difference| of every map and screen number from ``ref``'s."""
    import numpy as np

    small = max(float(np.abs(_map(a) - _map(b)).max()) for a, b in zip(res["small"],
                                                                        ref["small"]))
    big = {k: float(np.abs(_map(res["big"][k]["out"]) - _map(ref["big"][k]["out"])).max())
           for k in ref["big"]}

    def numbers(r):
        return [r["score"], r["max_prob"], *(c["p"] for c in r["top_contacts"])]

    key = lambda r: r["pair_id"]  # noqa: E731
    got, want = sorted(res["screen"]["ranked"], key=key), sorted(ref["screen"]["ranked"],
                                                                 key=key)
    if [r["pair_id"] for r in got] != [r["pair_id"] for r in want]:
        raise RuntimeError("the screens scored other pairs")
    screen = max(float(np.abs(np.subtract(numbers(a), numbers(b))).max())
                 for a, b in zip(got, want))
    return {"small_128x128": small, **{f"big_{k}": v for k, v in big.items()},
            "screen": screen}


def check_topology(name, res, shape) -> None:
    """``/healthz`` names the mesh, and every label and placement carries it."""
    label = "1x1" if name in ("one", "one_pair") else shape
    if res["health"]["mesh_shape"] != label or res["stats"]["mesh_shape"] != label:
        raise RuntimeError(f"{name}: mesh {res['health']['mesh_shape']}, expected {label}")
    prefix = "" if label == "1x1" else f"mesh{label}/"
    inventory = res["stats"]["compile_inventory"]
    if not all(lab.startswith(prefix) for lab in inventory):
        raise RuntimeError(f"{name}: labels {sorted(inventory)}")
    wants_pair = name == "one_pair" or (label != "1x1" and int(label.split("x")[1]) > 1)
    pairs = [lab for lab, info in inventory.items() if info["placement"] == "pair"]
    if wants_pair != bool(pairs):
        raise RuntimeError(f"{name}: pair keys {pairs}")
    for lab in pairs:
        sites = inventory[lab]["all_reduces"]
        if not {"halo", "pair_norm", "pair_se", "pair_gather"} <= set(sites):
            raise RuntimeError(f"{name}: {lab} holds the collectives {sites}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cards", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--log_dir", default=None)
    args, extra = parser.parse_known_args(argv)
    extra = [a for a in extra if a != "--"]
    on_cpu = "--device" in extra and extra[extra.index("--device") + 1] == "cpu"
    import numpy as np
    import torch

    if not on_cpu and torch.cuda.device_count() < args.cards:
        print(f"serve_mesh_check: {args.cards} CUDA devices needed, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from deepinteract_tpu_torch.data.synthetic import random_raw_complex

    if not on_cpu:
        cs.build_kernels()
    work = tempfile.mkdtemp(prefix="serve_mesh_check_")
    log_dir = args.log_dir or work
    os.makedirs(log_dir, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    bodies = {"small": [_npz(random_raw_complex(int(rng.integers(100, 129)),
                                                int(rng.integers(100, 129)), rng))
                        for _ in range(COALESCED)],
              "big": {f"{n1}x{n2}": _npz(random_raw_complex(n1, n2, rng)) for n1, n2 in BIG}}
    screen_payload = {"npz_paths": cs._write_complexes(work, "s", SCREEN_SIZES, args.seed),
                      "top_k": 10}
    base = ["--port", "0", "--seed", str(args.seed), "--max_batch", "8", "--max_delay_ms", "20",
            "--warmup_buckets", WARMUP, "--pair_shard_threshold", "512",
            "--result_cache_size", "0", "--screen_max_pairs", "256",
            "--rendezvous_dir", work, *extra]
    shapes = [s for s in SHAPES if int(s[0]) * int(s[2]) <= args.cards]
    runs = {"one": []} | {s: ["--mesh_shape", s] for s in shapes}
    if args.cards == 1:
        runs["one_pair"] = ["--shard_pair_map"]
    results, failed = {}, []
    for name, flags in runs.items():
        try:
            res = results[name] = run_worker(name, [*base, *flags], log_dir, bodies,
                                             screen_payload)
            if name != "one":
                res["max_abs_diff"] = compare(res, results["one"])
            _report(name, res)
            if res["rc"] != 0:
                raise RuntimeError(f"exited with code {res['rc']}")
            check_topology(name, res, name)
            if name != "one" and max(res["max_abs_diff"].values()) > BAR:
                raise RuntimeError(f"maps {res['max_abs_diff']} from the one-card worker's "
                                   f"(bar {BAR})")
        except Exception as exc:  # noqa: BLE001 - reported, then exit 1
            failed.append(name)
            print(f"serve_mesh_check: {name} failed: {exc}", flush=True)
            if name == "one":
                break
    summary = {name: {k: res.get(k) for k in ("start_to_warm_s", "coalesced_s",
                                              "coalesced_per_s", "screen_s", "max_abs_diff",
                                              "rc")}
               | {"served_ms": {k: v["served_ms"] for k, v in res["big"].items()},
                  "first_ms": {k: v["first_ms"] for k, v in res["big"].items()},
                  "keys": sorted(res["stats"]["compile_inventory"])}
               for name, res in results.items()}
    print(json.dumps({"serve_mesh_check": summary, "failed": failed}), flush=True)
    if not on_cpu:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    return 1 if failed else 0


def _report(name, res) -> None:
    big = ", ".join(f"{k} served {v['served_ms']:.3f} ms (first {v['first_ms']:.3f})"
                    for k, v in res["big"].items())
    print(f"{name}: start-to-warm {res['start_to_warm_s']:.3f} s; {COALESCED} 128x128 "
          f"from {CLIENTS} clients in {res['coalesced_s'] * 1e3:.3f} ms "
          f"({res['coalesced_per_s']:.3f} complexes/s); {big}; screen "
          f"{res['screen_s']:.3f} s; max |diff| {res.get('max_abs_diff')}; exit code "
          f"{res['rc']}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
