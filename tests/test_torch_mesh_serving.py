"""Serving's mesh placement (``cli.serve --mesh_shape DxP``: a worker as a
group of D*P gloo processes, ``serving/group.py``) against the port's
one-device engine and the JAX package's mesh engines
(``deepinteract_tpu/serving/engine.py`` on ``tests/conftest.py``'s 8
virtual CPU devices), on one set of JAX weights carried by
``weights.load_jax_variables``.

Four ``cli.serve`` workers, ``2x1``, ``1x2``, ``2x2`` and a group of one
(``--shard_pair_map``), all with ``--pair_shard_threshold 128``: 64-buckets
take the ``data`` placement, 128-buckets ``pair``. They run one after
another (a module-scoped fixture parametrized by topology), each rank a
process on one torch thread, every process the module starts sharing two
cores (``taskset``): the module never loads more of the machine than
that, beside the other test files that run with it. A worker meets at a
FileStore under the test's directory, answers a coalesced batch (two
concurrent requests, ``--max_batch 2``) and an asymmetric padded complex
alone. Bars: the data axis bitwise the one-device engine's map (the JAX
bar); the pair axis 1e-6 from it; both 1e-4 from the JAX mesh engine of
the same topology; the group of one bitwise. Then on each: the topology
in ``/healthz`` and ``/stats``, the warm path, a screen, and a drain
(every rank exits 0). Besides: the refusals, a fleet of one mesh worker,
and a SIGKILLed follower (the worker exits non-zero within its bound).
"""

import dataclasses
import io
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import pytest

from deepinteract_tpu.serving import EngineConfig as JaxEngineConfig
from deepinteract_tpu.serving import InferenceEngine as JaxInferenceEngine
from deepinteract_tpu_torch.data.io import save_complex_npz
from deepinteract_tpu_torch.data.synthetic import random_raw_complex
from deepinteract_tpu_torch.serving import EngineConfig, InferenceEngine, ServingServer
from deepinteract_tpu_torch.serving.fleet import batch_slots, mesh_placement
from deepinteract_tpu_torch.serving.group import LOSS_EXIT_BOUND_S, LOST_RANK_EXIT
from deepinteract_tpu_torch.weights import save_npz
from torch_port_helpers import (complexes, http_get, http_post, jax_cfg, port_cfg,
                                random_variables)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNN, LIMIT, THRESHOLD, MAX_DELAY_MS = 6, 128, 128, 1500.0
START_TIMEOUT_S, REQUEST_TIMEOUT_S = 150.0, 120.0
PAIR_BAR, JAX_BAR = 1e-6, 1e-4
# torch_port_helpers' tiny model with one decoder chunk (_port_cfg, JAX_CFG).
SMALL_FLAGS = ["--num_gnn_hidden_channels", "16", "--num_gnn_attention_heads", "2",
               "--num_interact_layers", "1", "--num_interact_hidden_channels", "16",
               "--node_count_limit", str(LIMIT)]
JAX_CFG = jax_cfg(limit=LIMIT, num_chunks=1)
WORKERS = {"2x1": ["--mesh_shape", "2x1"], "1x2": ["--mesh_shape", "1x2"],
           "2x2": ["--mesh_shape", "2x2"], "one": ["--shard_pair_map"]}
JAX_MESH = {"2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2), "one": None}
RANKS = {"2x1": 2, "1x2": 2, "2x2": 4, "one": 1}
LABELS = {"2x1": "2x1", "1x2": "1x2", "2x2": "2x2", "one": "1x1"}
# The two cores every process started here runs on (None: no taskset).
CORES = (",".join(map(str, sorted(os.sched_getaffinity(0))[-2:]))
         if shutil.which("taskset") else None)
# Per worker: (case, [(n1, n2) of each request, sent together], placement).
# An asymmetric complex has chains of unequal real lengths in one bucket.
CASES = {
    "2x1": [("coalesced", [(26, 22), (20, 17)], "data"), ("asymmetric", [(30, 9)], "data")],
    "1x2": [("coalesced", [(100, 90), (90, 70)], "pair"), ("asymmetric", [(120, 66)], "pair")],
    "2x2": [("coalesced", [(26, 22), (20, 17)], "data"), ("asymmetric", [(120, 66)], "pair")],
    "one": [("coalesced", [(100, 90), (90, 70)], "pair"), ("asymmetric", [(120, 66)], "pair")],
}


def fresh_raw(n1, n2):
    return random_raw_complex(n1, n2, np.random.default_rng(1000 * n1 + n2), knn=KNN)


def npz_bytes(raw) -> bytes:
    buf = io.BytesIO()
    save_complex_npz(buf, raw["graph1"], raw["graph2"], raw["examples"], "c")
    return buf.getvalue()


def serve_command(argv):
    """``cli.serve`` with ``argv``, on :data:`CORES` (its ranks inherit them)."""
    pin = ["taskset", "-c", CORES] if CORES else []
    return [*pin, sys.executable, "-m", "deepinteract_tpu_torch.cli.serve", *argv]


def serve_env():
    return dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
                OMP_NUM_THREADS="1")


class Worker:
    """One ``cli.serve`` worker (rank 0 and the ranks it starts); its
    output is collected by a reader thread."""

    def __init__(self, argv):
        self.proc = subprocess.Popen(serve_command(argv), cwd=REPO, env=serve_env(),
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.lines, self.port = [], None
        self._up = threading.Event()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line)
            if line.startswith("serving on"):
                self.port = int(line.split(":")[2].split()[0])
                self._up.set()
        self._up.set()

    def wait_up(self, timeout=START_TIMEOUT_S):
        assert self._up.wait(timeout) and self.port, f"worker never served:\n{self.log()}"

    def log(self) -> str:
        return "".join(self.lines)[-6000:]

    def get(self, path):
        status, body = http_get("127.0.0.1", self.port, path, timeout=REQUEST_TIMEOUT_S)
        return status, json.loads(body)

    def post(self, path, body, content_type="application/json"):
        status, body, _ = http_post("127.0.0.1", self.port, path, body=body,
                                    headers={"Content-Type": content_type},
                                    timeout=REQUEST_TIMEOUT_S)
        return status, json.loads(body)

    def predict(self, raw):
        status, out = self.post("/predict", npz_bytes(raw), "application/octet-stream")
        assert status == 200, out
        return out

    def stop(self, timeout=60.0):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            return self.proc.wait()


def _alive(pid) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    try:  # a zombie has exited
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


# ---------------------------------------------------------------------------
# Pure helpers (the JAX tests/test_mesh_serving.py :66-110, :401-432)
# ---------------------------------------------------------------------------

def test_mesh_placement_policy_and_the_group_of_one():
    from deepinteract_tpu.serving.fleet import mesh_placement as jax_placement

    for shape, b, thr in [((1, 1), 512, 512), ((4, 1), 512, 512), ((2, 2), 64, 512),
                          ((2, 2), 512, 512), ((2, 2), 512, 0), ((1, 4), 256, 128)]:
        assert mesh_placement(shape, b, b // 2, thr) == jax_placement(shape, b, b // 2, thr)
    # Port only: a pair axis of one takes the pair placement with
    # shard_pair_map; the rest of a group of one stays single.
    assert mesh_placement((1, 1), 512, 256, 512, shard_pair_map=True) == "pair"
    assert mesh_placement((1, 1), 256, 256, 512, shard_pair_map=True) == "single"
    assert mesh_placement((2, 1), 512, 512, 512, shard_pair_map=True) == "pair"
    assert mesh_placement((2, 1), 512, 512, 0, shard_pair_map=True) == "data"


def test_batch_slots_lift_to_the_data_axis():
    assert batch_slots(1, 8) == 1
    assert batch_slots(3, 8) == 4
    assert batch_slots(1, 8, lift_to=4) == 4
    assert batch_slots(6, 8, lift_to=4) == 8
    assert batch_slots(1, 2, lift_to=4) == 2


def test_warm_bucket_prefixes_carry_the_topology():
    from deepinteract_tpu.cli.serve import warm_bucket_prefixes as jax_prefixes
    from deepinteract_tpu_torch.cli.serve import warm_bucket_prefixes

    for spec, kw in [("128x128x1", {}), ("128x128x1", {"mesh_shape": (4, 1)}),
                     ("128x128x1,512x512x1", {"mesh_shape": (2, 2),
                                              "pair_shard_threshold": 512})]:
        assert warm_bucket_prefixes(spec, **kw) == jax_prefixes(spec, **kw)
    assert warm_bucket_prefixes("128x128x1,512x512x1", mesh_shape=(2, 2)) == (
        "mesh2x2/128x128/b2/", "mesh2x2/512x512/b1/")
    # A pair bucket keeps its slot floor on a data axis with shard_pair_map.
    assert warm_bucket_prefixes("64x64x1,512x512x1", mesh_shape=(2, 1),
                                shard_pair_map=True) == ("mesh2x1/64x64/b2/",
                                                         "mesh2x1/512x512/b1/")


def test_scheduler_flush_quantum_fires_on_a_full_mesh_batch():
    from deepinteract_tpu_torch.serving.scheduler import MicroBatchScheduler

    groups = []

    def flush(key, payloads):
        groups.append(len(payloads))
        return list(payloads)

    sched = MicroBatchScheduler(flush, max_batch=8, max_delay_ms=5000.0, flush_quantum=4)
    try:
        futs = [sched.submit("b", i) for i in range(4)]
        t0 = time.monotonic()
        assert [f.result(timeout=2.0) for f in futs] == [0, 1, 2, 3]
        assert time.monotonic() - t0 < 2.0  # not the 5 s delay
        assert groups == [4]
    finally:
        sched.drain(timeout=5.0)
    sched2 = MicroBatchScheduler(lambda key, payloads: payloads, max_batch=2, flush_quantum=64)
    try:
        assert sched2.flush_quantum == 2
    finally:
        sched2.drain(timeout=5.0)


def test_the_active_pair_group_is_per_thread():
    from deepinteract_tpu_torch.parallel.pair import active_pair, pair_sharded

    seen, inside, leave = [], threading.Event(), threading.Event()

    def hold():
        with pair_sharded("pair-group"):
            seen.append(active_pair())
            inside.set()
            leave.wait(10)

    t = threading.Thread(target=hold)
    t.start()
    assert inside.wait(10)
    seen.append(active_pair())
    leave.set()
    t.join(10)
    assert seen == ["pair-group", None] and active_pair() is None


def test_deeplab_on_a_pair_axis_raises_at_construction():
    from deepinteract_tpu_torch.models.vision import DeepLabConfig

    cfg = dataclasses.replace(_port_cfg(), interact_module_type="deeplab",
                   deeplab=DeepLabConfig(stem_channels=4, stage_channels=(4, 8, 8, 8),
                                         stage_blocks=(1, 1, 1, 1), aspp_rates=(2, 4, 6),
                                         decoder_channels=8, high_res_channels=4))
    for mesh, shard in (((1, 2), False), ((2, 2), False), ((1, 1), True)):
        with pytest.raises(ValueError, match="DeepLab decoder takes no pair placement"):
            InferenceEngine(cfg, cfg=EngineConfig(mesh_shape=mesh, shard_pair_map=shard),
                            device="cpu")
    with pytest.raises(ValueError, match="a mesh engine runs on its group"):
        InferenceEngine(_port_cfg(), cfg=EngineConfig(mesh_shape=(2, 1)),
                        device="cpu")


@pytest.mark.parametrize("argv,message", [
    (["--mesh_shape", "64x64"], "--mesh_shape 64x64 needs 4096 devices: this host has"),
    (["--mesh_shape", "1x2", "--interact_module_type", "deeplab"],
     "DeepLab decoder takes no pair placement"),
    (["--shard_pair_map", "--interact_module_type", "deeplab"],
     "DeepLab decoder takes no pair placement"),
    (["--mesh_shape", "1x16", "--warmup_buckets", "64x64x1", "--pair_shard_threshold", "64"],
     "warm-up key 64x64 on mesh 1x16: pair-map sharding: a shard of 4 rows is narrower than"),
    (["--mesh_shape", "1x3", "--warmup_buckets", "128x128x1", "--pair_shard_threshold", "64"],
     "128 rows do not split over 3 pair shards"),
    (["--num_pair_shards", "2"], "a served pair axis is --mesh_shape Dx2"),
])
def test_cli_serve_refuses_an_unservable_mesh_before_serving(argv, message, capsys):
    from deepinteract_tpu_torch.cli.serve import main

    assert main(["--device", "cpu", "--port", "0", *argv]) == 2
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("flags", [["--shard_pair_map"], ["--num_pair_shards", "2"]])
def test_cli_predict_refuses_the_pair_flags(flags, tmp_path, capsys):
    """The JAX predict parses both flags but makes no mesh, so its sharded
    decode fails at its first trace; the port's refuses them up front and
    names the served path."""
    from deepinteract_tpu_torch.cli.predict import main

    raw = fresh_raw(30, 24)
    path = str(tmp_path / "c.npz")
    save_complex_npz(path, raw["graph1"], raw["graph2"], raw["examples"], "c")
    assert main(["--input_npz", path, "--output_dir", str(tmp_path / "out"), "--device", "cpu",
                 *flags]) == 2
    assert "cli.serve --mesh_shape DxP" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()


# ---------------------------------------------------------------------------
# The workers, the one-device engines and the JAX mesh engines
# ---------------------------------------------------------------------------

def _port_cfg():
    cfg = port_cfg(limit=LIMIT)
    return dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, num_chunks=1))


@pytest.fixture(scope="module")
def variables():
    """One random JAX variables tree (no compile: ``jax.eval_shape``)."""
    jcx, _ = complexes()
    return random_variables(JAX_CFG, jcx, seed=5)


@pytest.fixture(scope="module")
def weights(tmp_path_factory, variables):
    """``variables`` as the ``--weights`` file every worker serves."""
    path = str(tmp_path_factory.mktemp("mesh_weights") / "w.npz")
    save_npz(path, variables)
    return path


def _jax_engine(variables, mesh=None):
    """A JAX engine serving ``variables``: its jitted weight init (a
    compile per engine, ~20 s here) is replaced by the shared tree."""
    def reuse(self, seed, ckpt_dir, metric_to_track):
        self.params, self.batch_stats = variables["params"], variables["batch_stats"]
        self.restored_from = None

    with mock.patch.object(JaxInferenceEngine, "_init_weights", reuse):
        return JaxInferenceEngine(JAX_CFG, cfg=JaxEngineConfig(
            max_batch=2, mesh_shape=mesh, pair_shard_threshold=THRESHOLD))


def _one_device(variables, max_delay_ms, move=0.0):
    """A one-device engine on the JAX weights (moved by ``move`` relative)."""
    if move:
        import jax

        variables = jax.tree_util.tree_map(lambda a: np.asarray(a) * (1 + move), variables)
    return InferenceEngine(_port_cfg(), cfg=EngineConfig(
        max_batch=2, max_delay_ms=max_delay_ms, result_cache_size=0), device="cpu",
        weights=variables)


@pytest.fixture(scope="module")
def one_device(variables):
    """The one-device engines: coalescing (``--max_batch 2`` and the
    workers' delay), one that flushes each request alone, and the first
    with every weight moved by 1e-7 relative (the spread of a bar)."""
    engines = (_one_device(variables, MAX_DELAY_MS), _one_device(variables, 0.0),
               _one_device(variables, MAX_DELAY_MS, move=1e-7))
    yield engines
    for eng in engines:
        eng.close()


def _together(engine, raws):
    return [f.result(timeout=REQUEST_TIMEOUT_S) for f in [engine.submit(r) for r in raws]]


def _references(name, variables, one_device):
    """A worker's cases through the one-device engines (submitted
    together, alone, and moved) and the JAX engine of its topology."""
    together, alone, moved = one_device
    jeng = _jax_engine(variables, JAX_MESH[name])
    refs = {}
    try:
        for case, sizes, placement in CASES[name]:
            raws = [fresh_raw(*nn) for nn in sizes]
            refs[case] = {
                "placement": placement, "sizes": sizes,
                "ref": _together(together, raws),
                "alone": [alone.predict(raw) for raw in raws],
                "moved": _together(moved, raws),
                "jax": [np.asarray(jeng.predict(raw)["probs"]) for raw in raws]}
    finally:
        jeng.close()
    return refs


@pytest.fixture(scope="module", params=list(WORKERS))
def worker(request, tmp_path_factory, weights, variables, one_device):
    """One topology's worker, after its references, serving its cases
    (each case's requests sent together). Its tests run before the next
    topology's worker starts; the last of them drains it."""
    name = request.param
    refs = _references(name, variables, one_device)
    tmp = tmp_path_factory.mktemp(f"mesh_{name}")
    w = Worker(["--device", "cpu", "--port", "0", "--weights", weights, "--max_batch", "2",
                "--max_delay_ms", str(MAX_DELAY_MS), "--pair_shard_threshold", str(THRESHOLD),
                "--result_cache_size", "0", "--rendezvous_dir", str(tmp / "rendezvous"),
                *SMALL_FLAGS, *WORKERS[name]])
    try:
        w.wait_up()
        for case, sizes, _ in CASES[name]:
            with ThreadPoolExecutor(max_workers=len(sizes)) as pool:
                refs[case]["got"] = list(pool.map(w.predict, [fresh_raw(*nn) for nn in sizes]))
        w.name, w.refs = name, refs
        yield w
    finally:
        if w.proc.poll() is None:
            w.proc.kill()
            w.proc.wait()


@pytest.mark.parametrize("case", ["coalesced", "asymmetric"])
def test_mesh_maps_match_the_one_device_engine_and_the_jax_mesh_engine(worker, case):
    """The data axis: bitwise the one-device engine at the batch a data
    rank decodes (one slot each here), and within 1e-6 plus four times
    the float32 spread of the coalesced one-device map (on the CPU a
    slot's map moves with its batch's size: up to 8.4e-9 here). The pair
    axis within rtol 1e-6 / atol 1e-6 of the one-device map (the JAX
    bar), the group of one bitwise;
    everything 1e-4 from the JAX mesh engine."""
    res = worker.refs[case]
    rows = zip(res["sizes"], res["got"], res["ref"], res["alone"], res["moved"], res["jax"])
    for (n1, n2), got, ref, alone, moved, jax_map in rows:
        probs = np.asarray(got["contact_probs"], dtype=np.float32)
        assert probs.shape == (n1, n2) and got["coalesced"] == len(res["sizes"])
        assert ref["coalesced"] == len(res["sizes"])
        if worker.name == "one":
            # One pair rank's halo adds exact zeros.
            assert np.array_equal(probs, ref["probs"]), np.abs(probs - ref["probs"]).max()
        elif res["placement"] == "data":
            assert np.array_equal(probs, alone["probs"]), np.abs(probs - alone["probs"]).max()
            spread = float(np.abs(moved["probs"] - ref["probs"]).max())
            np.testing.assert_allclose(probs, ref["probs"], rtol=0, atol=PAIR_BAR + 4 * spread)
        else:
            # The JAX bar: row sharding reorders the norms' sums.
            np.testing.assert_allclose(probs, ref["probs"], rtol=PAIR_BAR, atol=PAIR_BAR)
        np.testing.assert_allclose(probs, jax_map, rtol=0, atol=JAX_BAR)


def test_the_topology_reaches_healthz_stats_and_every_label(worker):
    name, label = worker.name, LABELS[worker.name]
    status, health = worker.get("/healthz")
    assert status == 200 and health["mesh_shape"] == label
    stats = worker.get("/stats")[1]["engine"]
    assert stats["mesh_shape"] == label and stats["group"]["ranks"] == RANKS[name]
    inventory = stats["compile_inventory"]
    assert sorted(health["warm_buckets"]) == sorted(inventory)
    assert {info["placement"] for info in inventory.values()} == {
        placement for _, _, placement in CASES[name]}
    for lab, info in inventory.items():
        assert info["mesh_shape"] == label
        assert lab.startswith("" if name == "one" else f"mesh{label}/")
        assert lab.endswith("/pair") == (info["placement"] == "pair")
        sites = set(info["all_reduces"])
        if info["placement"] == "pair":
            assert {"halo", "pair_norm", "pair_se", "pair_gather"} == sites, (lab, info)
        elif info["placement"] == "data" and name != "1x2":
            assert sites == {"slot_gather"}, (lab, info)
        else:
            assert not sites, (lab, info)
    if name == "2x2":
        assert "mesh2x2/64x64/b2/k6g2" in inventory
        assert "mesh2x2/128x128/b1/k6g2/pair" in inventory


def test_a_warm_key_captures_nothing_more(worker):
    before = worker.get("/stats")[1]["engine"]["capture_count"]
    for _, sizes, _ in CASES[worker.name]:
        with ThreadPoolExecutor(max_workers=len(sizes)) as pool:
            list(pool.map(worker.predict, [fresh_raw(n1 + 1, n2) for n1, n2 in sizes]))
    assert worker.get("/stats")[1]["engine"]["capture_count"] == before


def _screen(engine, payload):
    server = ServingServer(engine, port=0)
    try:
        return server.run_screen(dict(payload))
    finally:
        server.httpd.server_close()


def _numbers(record):
    """A screen record's probabilities: its score, max and top-k values."""
    return np.array([record["score"], record["max_prob"],
                     *(c["p"] for c in record["top_contacts"])])


def _shape(record):
    return {k: v for k, v in record.items() if k not in ("score", "max_prob", "top_contacts")}


@pytest.fixture(scope="module")
def screen(tmp_path_factory, one_device):
    """A screen of two complexes (four chains, all 64-buckets): its
    payload, and the one-device engine's answer and its 1e-7-moved
    twin's."""
    tmp = tmp_path_factory.mktemp("mesh_screen")
    paths = []
    for i, (n1, n2) in enumerate([(30, 24), (40, 33)]):
        raw = random_raw_complex(n1, n2, np.random.default_rng(70 + i), knn=KNN)
        paths.append(str(tmp / f"c{i}.npz"))
        save_complex_npz(paths[-1], raw["graph1"], raw["graph2"], raw["examples"], f"c{i}")
    payload = {"npz_paths": paths, "top_k": 5}
    return (payload, json.loads(json.dumps(_screen(one_device[0], payload))),
            json.loads(json.dumps(_screen(one_device[2], payload))))


def test_a_screen_gives_the_one_device_maps(worker, screen):
    """``/screen`` over the worker (its encodes and decodes of 2 slots
    split over a data axis) against the one-device engine's screen: the
    same pairs, chains, orientation, buckets, top contacts and encode
    counts; probabilities within 1e-6 plus four times the 1e-7-moved
    engine's spread."""
    payload, ref, moved = screen
    status, got = worker.post("/screen", json.dumps(payload).encode())
    assert status == 200, got
    assert got["pairs"] == ref["pairs"] == 6 and got["chains"] == ref["chains"] == 4
    for key in ("encodes_executed", "encode_cache_hits", "decode_batches"):
        assert got[key] == ref[key], key
    spread = max(float(np.abs(_numbers(a) - _numbers(b)).max())
                 for a, b in zip(moved["ranked"], ref["ranked"]))
    assert [_shape(r) for r in got["ranked"]] == [_shape(r) for r in ref["ranked"]]
    for a, b in zip(got["ranked"], ref["ranked"]):
        assert [(c["i"], c["j"]) for c in a["top_contacts"]] == [
            (c["i"], c["j"]) for c in b["top_contacts"]]
        np.testing.assert_allclose(_numbers(a), _numbers(b), rtol=0,
                                   atol=PAIR_BAR + 4 * spread)
    prefix = "" if worker.name == "one" else f"mesh{LABELS[worker.name]}/"
    inventory = worker.get("/stats")[1]["engine"]["compile_inventory"]
    encodes = {info["placement"] for lab, info in inventory.items()
               if lab.startswith(f"{prefix}enc:")}
    assert encodes == {"data"}, inventory


def test_a_drain_stops_every_rank_with_exit_0(worker):
    pids = [int(p) for p in worker.get("/stats")[1]["engine"]["group"]["pids"].values()]
    assert len(pids) == RANKS[worker.name]
    assert worker.stop() == 0, worker.log()
    assert "serving group is lost" not in worker.log(), worker.log()
    assert not any(_alive(pid) for pid in pids)


def test_a_fleet_of_one_mesh_worker_routes_to_its_group(weights, one_device, tmp_path):
    """``cli.serve --workers 1 --mesh_shape 1x2``: the engine worker is a
    group (its rendezvous under the fleet's state directory), the router
    sees its topology and routes a pair-bucket request to it, and SIGTERM
    ends the fleet with a ``fleet/v1`` line that names the mesh."""
    fleet_dir = tmp_path / "fleet"
    proc = subprocess.Popen(
        serve_command(["--workers", "1", "--mesh_shape", "1x2", "--pair_shard_threshold",
                       str(THRESHOLD), "--device", "cpu", "--port", "0", "--weights", weights,
                       "--max_delay_ms", "5", "--result_cache_size", "0",
                       "--probe_interval_s", "0.2", "--fleet_dir", str(fleet_dir),
                       *SMALL_FLAGS]),
        cwd=REPO, env=serve_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("fleet router on http://"), (line, proc.poll())
        host, port = line.split("//")[1].split()[0].rsplit(":", 1)
        port = int(port)
        deadline = time.monotonic() + START_TIMEOUT_S
        while json.loads(http_get(host, port, "/healthz")[1])["healthy"] < 1:
            assert time.monotonic() < deadline and proc.poll() is None, "never healthy"
            time.sleep(0.1)
        assert list((fleet_dir / "groups").iterdir()) == [fleet_dir / "groups" / "w1"]
        raw = fresh_raw(120, 66)
        status, body, headers = http_post(host, port, body=npz_bytes(raw), timeout=120.0,
                                          headers={"Content-Type": "application/octet-stream",
                                                   "X-DI-Bucket": "128x128"})
        assert status == 200 and headers["X-DI-Worker"] == "w1", body[:300]
        probs = np.asarray(json.loads(body)["contact_probs"], dtype=np.float32)
        np.testing.assert_allclose(probs, one_device[1].predict(raw)["probs"], rtol=PAIR_BAR,
                                   atol=PAIR_BAR)
        stats = json.loads(http_get(host, port, "/stats")[1])
        assert stats["fleet"]["workers"]["w1"]["health"]["mesh_shape"] == "1x2"
        assert stats["workers"]["w1"]["engine"]["mesh_shape"] == "1x2"
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    record = json.loads(out.strip().splitlines()[-1])
    assert record["schema"] == "fleet/v1" and record["mesh_shape"] == "1x2" and record["ok"]


def test_a_killed_follower_ends_the_worker_non_zero_within_its_bound(weights, tmp_path):
    worker = Worker(["--device", "cpu", "--port", "0", "--weights", weights,
                     "--mesh_shape", "1x2", "--rendezvous_dir", str(tmp_path), *SMALL_FLAGS])
    try:
        worker.wait_up()
        follower = int(worker.get("/stats")[1]["engine"]["group"]["pids"]["1"])
        os.kill(follower, signal.SIGKILL)
        t0 = time.monotonic()
        rc = worker.proc.wait(timeout=60)
        assert rc == LOST_RANK_EXIT, worker.log()
        assert time.monotonic() - t0 <= LOSS_EXIT_BOUND_S, worker.log()
    finally:
        worker.stop()
