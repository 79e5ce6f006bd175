"""Device times of the edge-attention kernels K1 and K2, and of the in-edge
CSR build where the package has one, for the ``deepinteract_tpu_torch`` of
any checkout, on one GPU.

    python3 kernel_times.py [--root DIR] [--seed 0]

Times with ``chip_smoke.py``'s cases and timer (this checkout's: B=1,
K=20, H*D=128 float32, N = 64, 128, 192, 256 and 512, each kernel beside
its bound) against the package under DIR (default: this checkout). So two
versions of the kernels can be compared on one card in one call: run it
with ``--root`` at an older checkout and without, in turns. A package from
before the CSR is timed as it is: its kernels find their in-edges
themselves. Prints one JSON line per N, then the card's name and power
limit. Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _without_csr(wrapper):
    """``wrapper`` of a package from before the CSR, taking (and dropping)
    ``in_edges``; it counts its launches on the replacement, the name it
    looks up."""
    def call(*args, in_edges=None, **kwargs):
        return wrapper(*args, **kwargs)

    call.launches = 0
    return call


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(HERE))
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device available", file=sys.stderr)
        return 1
    ops = smoke.cuda_attention
    has_csr = hasattr(ops, "in_edge_csr")
    if not has_csr:
        ops.in_edge_csr = lambda nbr: None
        ops.edge_attention_forward = _without_csr(ops.edge_attention_forward)
        ops.edge_attention_backward = _without_csr(ops.edge_attention_backward)
    smoke.log(f"== kernels of {Path(ops.__file__).resolve().parents[2]}")
    smoke.build_kernels()
    rng = np.random.default_rng(args.seed)
    flagship = smoke.attention_case(rng, 1, 200, 256, 20, 4, 32, torch.float32)
    times = smoke.time_kernels(rng, flagship, smoke.backward_case(rng, flagship))
    for n, row in times["by_n"].items():
        print(json.dumps({"root": args.root, "n": n, **row,
                          "csr_ms": row["csr_ms"] if has_csr else None}), flush=True)
    print(smoke.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
