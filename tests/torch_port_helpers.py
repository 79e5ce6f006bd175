"""Shared fixtures of the PyTorch-port parity tests (tests/test_torch_*.py).

Both packages see the same inputs and the same weights: complexes come
from one numpy seed through each package's own generator, and weights are
one random JAX variables tree (fan-in-scaled, as
``training.import_torch.synthesize_reference_state_dict`` makes them)
carried into the port by ``weights.load_jax_variables``. The size is the
golden fixture's: hidden 16, 2 heads, kNN 6, 26x22 residues (padded to
32 so that masks matter), 2 decoder chunks of 16 channels.
"""

from __future__ import annotations

import http.client
import time
from collections.abc import Mapping

import jax
import numpy as np
import torch

from deepinteract_tpu.data.graph import stack_complexes as jax_stack
from deepinteract_tpu.data.synthetic import random_complex as jax_random_complex
from deepinteract_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
from deepinteract_tpu.models.geometric_transformer import GTConfig as JaxGTConfig
from deepinteract_tpu.models.model import DeepInteract as JaxDeepInteract
from deepinteract_tpu.models.model import ModelConfig as JaxModelConfig
from deepinteract_tpu_torch.data.graph import stack_complexes
from deepinteract_tpu_torch.data.synthetic import random_complex
from deepinteract_tpu_torch.models.decoder import DecoderConfig
from deepinteract_tpu_torch.models.geometric_transformer import GTConfig
from deepinteract_tpu_torch.models.model import ModelConfig

HIDDEN, HEADS, KNN, N1, N2, PAD, LIMIT, CHUNKS = 16, 2, 6, 26, 22, 32, 64, 2

# The suite runs in several worker processes at once, and each one imports
# this module while collecting. torch's default of one intra-op thread per
# core then oversubscribes the machine: its spinning threads slow every
# other worker and the subprocesses their tests start. At these tensor
# sizes one thread is as fast.
torch.set_num_threads(1)


def jax_cfg(attention_impl: str = "jnp", norm_type: str = "batch",
            attention_mode: str = "scatter", limit: int = LIMIT,
            **decoder) -> JaxModelConfig:
    """The tiny JAX config. The decoder defaults to the plain masked
    formulation (``depad_stats=False``), which is the one the port
    implements; the JAX package's de-padded statistics agree with it only
    up to float association."""
    return JaxModelConfig(
        gnn=JaxGTConfig(hidden=HIDDEN, num_heads=HEADS, dropout_rate=0.0,
                        node_count_limit=limit, attention_impl=attention_impl,
                        norm_type=norm_type, attention_mode=attention_mode),
        decoder=JaxDecoderConfig(**{"num_chunks": CHUNKS, "num_channels": HIDDEN,
                                    "depad_stats": False, **decoder}))


def port_cfg(attention_impl: str = "auto", norm_type: str = "batch",
             attention_mode: str = "scatter", limit: int = LIMIT, **kw) -> ModelConfig:
    return ModelConfig(
        gnn=GTConfig(hidden=HIDDEN, num_heads=HEADS, node_count_limit=limit,
                     attention_impl=attention_impl, norm_type=norm_type,
                     attention_mode=attention_mode),
        decoder=DecoderConfig(num_chunks=CHUNKS, num_channels=HIDDEN), **kw)


def complexes(seed: int = 3, pad: int = PAD, n1: int = N1, n2: int = N2):
    """(JAX batch, port batch) of one synthetic complex from one seed."""
    jcx = jax_stack([jax_random_complex(n1, n2, np.random.default_rng(seed),
                                        n_pad1=pad, n_pad2=pad, knn=KNN)])
    cx = stack_complexes([random_complex(n1, n2, np.random.default_rng(seed),
                                         n_pad1=pad, n_pad2=pad, knn=KNN)])
    return jcx, cx


def _iter_leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _iter_leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def random_like(shapes, seed: int = 0) -> dict:
    """Random arrays in the structure of an abstract flax variables tree
    (``jax.eval_shape`` of an init: no compile): fan-in-scaled normal
    kernels (the scanned chunk axis is not fan-in), normal vectors, and
    positive running variances."""
    rng = np.random.default_rng(seed)
    out: dict = {}
    for path, leaf in _iter_leaves(shapes):
        value = rng.standard_normal(leaf.shape).astype(np.float32)
        if len(leaf.shape) >= 2:
            fan = leaf.shape[1:-1] if "chunks" in path else leaf.shape[:-1]
            value /= np.sqrt(max(int(np.prod(fan)), 1))
        if path[-1] == "var":
            value = np.abs(value) + 0.5
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return out


def flax_random_apply(module, *args, seed: int = 0, **kwargs):
    """(random variables, module.apply(variables, *args)) for a flax module."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    variables = random_like(shapes, seed)
    return variables, module.apply(variables, *args, **kwargs)


def random_variables(jcfg: JaxModelConfig, jcx, seed: int = 0) -> dict:
    """Random variables of the whole JAX model for one complex batch."""
    model = JaxDeepInteract(jcfg)
    return random_like(jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jcx.graph1, jcx.graph2, train=False)), seed)


# ---------------------------------------------------------------------------
# PDB writers (tests/test_torch_pipeline.py, tests/test_torch_builder_cli.py):
# the same files go through both packages' featurizers.
# ---------------------------------------------------------------------------

def write_helix_pdb(path, n_res=12, chain="A"):
    """Synthetic ideal alpha-helix poly-alanine PDB (right-handed, 100
    degrees/residue, 1.5 A rise): a copy of ``tests/test_pipeline.py``'s
    ``_write_helix_pdb``."""
    lines = []
    serial = 1
    atom_r = {"N": 1.56, "CA": 2.28, "C": 1.68, "O": 2.00, "CB": 3.30}
    atom_dphi = {"N": -0.48, "CA": 0.0, "C": 0.50, "O": 0.70, "CB": -0.2}
    atom_dz = {"N": -0.60, "CA": 0.0, "C": 0.65, "O": 1.80, "CB": -0.5}
    for i in range(n_res):
        phi0 = np.radians(100.0) * i
        z0 = 1.5 * i
        for name in ("N", "CA", "C", "O", "CB"):
            phi = phi0 + atom_dphi[name]
            x = atom_r[name] * np.cos(phi)
            y = atom_r[name] * np.sin(phi)
            z = z0 + atom_dz[name]
            el = name[0]
            lines.append(
                f"ATOM  {serial:5d} {name:<4s} ALA {chain}{i + 1:4d}    "
                f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00          {el:>2s}"
            )
            serial += 1
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\nEND\n")
    return path


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


def mixed_chain_lines(n_res, chain="A", x0=0.0, first=0, serial=1):
    """ATOM records of a helix of ``n_res`` residues cycling through the 20
    standard types from type ``first``, side chains pointing away from the
    axis, which runs along z through (x0, 0)."""
    resnames = list(SIDE_CHAINS)
    backbone = {"N": (1.56, -0.48, -0.60), "CA": (2.28, 0.0, 0.0), "C": (1.68, 0.50, 0.65),
                "O": (2.00, 0.70, 1.80)}
    lines = []
    for i in range(n_res):
        resname = resnames[(first + i) % len(resnames)]
        phi0, z0 = np.radians(100.0) * i, 1.5 * i
        atoms = [(name, r, phi0 + dphi, z0 + dz) for name, (r, dphi, dz) in backbone.items()]
        atoms += [(name, 3.3 + 1.1 * k, phi0 - 0.2 + 0.3 * (k % 3 - 1), z0 - 0.5 + 0.4 * (k % 2))
                  for k, name in enumerate(SIDE_CHAINS[resname])]
        for name, r, phi, z in atoms:
            x, y = x0 + r * np.cos(phi), r * np.sin(phi)
            lines.append(f"ATOM  {serial:5d} {name:<4s} {resname} {chain}{i + 1:4d}    "
                         f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00          {name[0]:>2s}")
            serial += 1
    return lines


def write_mixed_pdb(path, n_res, chain="A", x0=0.0, first=0):
    """One mixed-residue helix (``mixed_chain_lines``) as a PDB file."""
    with open(path, "w") as f:
        f.write("\n".join(mixed_chain_lines(n_res, chain, x0, first)) + "\nEND\n")
    return path


def write_bound_pdb(path, n1, n2, x0=11.0):
    """Two mixed-residue helices, chains A and B, ``x0`` apart: one bound
    complex whose side chains touch."""
    a = mixed_chain_lines(n1, "A")
    b = mixed_chain_lines(n2, "B", x0=x0, first=7, serial=len(a) + 1)
    with open(path, "w") as f:
        f.write("\n".join(a) + "\nTER\n" + "\n".join(b) + "\nEND\n")
    return path


def wait_until(cond, timeout: float = 30.0, poll: float = 0.002) -> None:
    """Poll ``cond`` until it holds (the serving tests' event-driven waits:
    a poll, never a fixed sleep); fails after ``timeout`` seconds."""
    t_end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < t_end, "condition not reached"
        time.sleep(poll)


# ---------------------------------------------------------------------------
# Fleet helpers (tests/test_torch_fleet.py, tests/test_torch_elastic.py):
# real multi-process fleets of stub workers. Every wait polls with a bound;
# ports come from the OS.
# ---------------------------------------------------------------------------

# Stub knobs shared by every fleet: fast beats, fast probes.
STUB_OVERRIDES = {"weights_signature": "v1", "delay_ms": 5, "heartbeat_interval_s": 0.2}


def make_supervisor(tmp_path, n=2, overrides=None, cmd_fn=None, **cfg_kw):
    from deepinteract_tpu_torch.serving.fleet import (FleetConfig, WorkerSupervisor,
                                                      stub_worker_cmd)

    cfg_kw.setdefault("probe_interval_s", 0.15)
    cfg_kw.setdefault("heartbeat_max_age_s", 5.0)
    cfg_kw.setdefault("restart_backoff_s", 0.05)
    return WorkerSupervisor(
        cmd_fn or stub_worker_cmd,
        FleetConfig(num_workers=n, state_dir=str(tmp_path / "fleet"), **cfg_kw),
        overrides={**STUB_OVERRIDES, **(overrides or {})})


def make_fleet(tmp_path, n=2, overrides=None, router_cfg=None, **cfg_kw):
    from deepinteract_tpu_torch.serving.router import FleetRouter, RouterConfig

    sup = make_supervisor(tmp_path, n=n, overrides=overrides, **cfg_kw)
    router = FleetRouter(sup, port=0, cfg=router_cfg or RouterConfig(
        proxy_timeout_s=10.0, warm_timeout_s=30.0, drain_timeout_s=10.0))
    router.start()
    wait_routable(sup, n)
    return sup, router


def wait_routable(sup, n, timeout=25.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        sup.poll_once()
        if len(sup.routable_workers()) >= n:
            return
        time.sleep(0.05)
    raise AssertionError(f"fleet never reached {n} routable workers: {sup.stats()}")


def http_post(host, port, path="/predict", body=b"{}", headers=None, timeout=10.0):
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", path, body=body,
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, resp.read(), dict(resp.getheaders())
    finally:
        conn.close()


def http_get(host, port, path, timeout=10.0):
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()
