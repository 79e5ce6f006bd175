"""Data-parallel training over torch.distributed (``parallel/``) at world
size 2 on gloo, against the JAX package's single-device step and the
port's single-process step on the global batch.

Two complexes of different lengths share one bucket: rank 0 holds the
first, rank 1 the second, and the global batch stacks both, so a mean of
per-rank means (or per-rank batch statistics) would differ from the
global step. Both ranks run in spawned processes that meet at a FileStore
under the test's directory, with torch on one intra-op thread:
* dropout 0: the loss within 1e-5 of JAX's ``train_step`` on the global
  batch; the grad norm, parameters and batch-norm running statistics
  within 1e-4 plus four times the JAX reference's own spread (ROADMAP
  queue 3: batch-norm gradients move with rounding-level weight moves, and
  AdamW's first update turns rounding-level gradients of near-zero-gradient
  parameters into moves of up to the learning rate);
* dropout 0.2: the same bars against the port's single-process step
  (dropout masks of the global batch), and every gradient within 1e-4
  plus four times the port's spread (queue 3: batch-norm gradients);
* a non-finite batch on rank 1 only: both ranks skip and end bitwise
  equal, then take the next step together;
* the step's all-reduces, counted by site;
* ``cli.train`` over two processes end to end.
"""

import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinteract_tpu.data.graph import stack_complexes as jax_stack
from deepinteract_tpu.data.synthetic import random_complex as jax_random_complex
from deepinteract_tpu.models.model import DeepInteract as JaxDeepInteract
from deepinteract_tpu.training.optim import OptimConfig as JaxOptimConfig
from deepinteract_tpu.training.optim import make_optimizer
from deepinteract_tpu.training.steps import TrainState as JaxTrainState
from deepinteract_tpu.training.steps import train_step as jax_train_step
from deepinteract_tpu_torch.data.graph import stack_complexes
from deepinteract_tpu_torch.data.synthetic import random_complex
from deepinteract_tpu_torch.models.model import DeepInteract
from deepinteract_tpu_torch.training.steps import create_train_state, train_step
from deepinteract_tpu_torch.weights import load_jax_variables
from torch_port_helpers import KNN, PAD, jax_cfg, port_cfg, random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = ((26, 22), (20, 17))  # one bucket (padded to 32), unequal valid pairs
SEED = 5
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
TIMEOUT_S = 240

# One rank: every scenario's step on its own batch, through the
# data-parallel step factory; writes metrics, state and counts.
WORKER = r"""
import sys
import torch
torch.set_num_threads(1)
from deepinteract_tpu_torch.models.layers import MaskedBatchNorm
from deepinteract_tpu_torch.models.model import DeepInteract
from deepinteract_tpu_torch.parallel import mesh as mesh_lib, multihost
from deepinteract_tpu_torch.parallel.train import make_sharded_train_step
from deepinteract_tpu_torch.training.steps import create_train_state

spec_path, store, rank, out_path = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]
spec = torch.load(spec_path, weights_only=False)
multihost.initialize_distributed(f"file://{store}", 2, rank, device="cpu", timeout_s=120)
mesh = mesh_lib.make_mesh(num_data=2)
out = {"backend": mesh.backend, "world": mesh.world}
for name, sc in spec.items():
    model = DeepInteract(sc["cfg"])
    model.load_state_dict(sc["weights"])
    state = create_train_state(model, seed=sc["seed"])
    calls = []
    for m in model.modules():
        if isinstance(m, MaskedBatchNorm):
            m.register_forward_hook(lambda mod, i, o: calls.append(1) if mod.training else None)
    step = make_sharded_train_step(mesh, guard=sc["guard"])
    results = []
    for batches in sc["steps"]:
        before = dict(mesh_lib.ALL_REDUCES)
        calls.clear()
        metrics = step(state, batches[rank])
        reduces = {k: v - before.get(k, 0) for k, v in mesh_lib.ALL_REDUCES.items()
                   if v != before.get(k, 0)}
        results.append({"metrics": metrics, "reduces": reduces, "bn_calls": len(calls),
                        "grads": state.optimizer.grads().clone(),
                        "model": {k: v.clone() for k, v in model.state_dict().items()},
                        "tensors": [t.clone() for t in state.tensors()]})
    out[name] = results
torch.save(out, out_path)
multihost.exit_barrier()
"""


def _global_batches():
    """(JAX global batch, port global batch, port per-rank batches)."""
    jcx = [jax_random_complex(n1, n2, np.random.default_rng(SEED + i), n_pad1=PAD, n_pad2=PAD,
                              knn=KNN) for i, (n1, n2) in enumerate(SIZES)]
    cx = [random_complex(n1, n2, np.random.default_rng(SEED + i), n_pad1=PAD, n_pad2=PAD,
                         knn=KNN) for i, (n1, n2) in enumerate(SIZES)]
    return jax_stack(jcx), stack_complexes(cx), [stack_complexes([c]) for c in cx]


def _shallow(cfg):
    """One GT layer and one decoder chunk: the JAX step compiles in half
    the time, and each batch norm is still taken over the global batch."""
    return dataclasses.replace(cfg, gnn=dataclasses.replace(cfg.gnn, num_layers=1),
                               decoder=dataclasses.replace(cfg.decoder, num_chunks=1))


JAX_CFG = _shallow(jax_cfg())


def _port_model(variables, dropout_rate=0.0):
    cfg = _shallow(port_cfg())
    cfg = dataclasses.replace(cfg, gnn=dataclasses.replace(cfg.gnn, dropout_rate=dropout_rate))
    model = DeepInteract(cfg)
    load_jax_variables(model, variables)
    return model


def _poisoned(batch):
    return dataclasses.replace(batch, graph1=dataclasses.replace(
        batch.graph1, node_feats=torch.full_like(batch.graph1.node_feats, float("nan"))))


def _perturbed(variables, seed):
    """The variables with every parameter scaled by (1 + 1e-7 * noise)."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) * (1 + 1e-7 * rng.standard_normal(a.shape)).astype(np.float32),
        variables["params"])
    return dict(variables, params=params)


def spawn_ranks(argv_of_rank, timeout=TIMEOUT_S):
    """Run ``python <argv_of_rank(rank)>`` for ranks 0 and 1 from the repo
    root; fails with the output of a rank that fails or times out."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, *argv_of_rank(rank)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for rank in range(2)]
    outs = []
    for rank, proc in enumerate(procs):
        try:
            out, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            pytest.fail(f"rank {rank} timed out:\n{proc.communicate()[0][-4000:]}")
        outs.append(out)
        assert proc.returncode == 0, f"rank {rank} failed:\n{out[-6000:]}"
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ranks' results of every scenario, with the inputs they came from."""
    tmp = tmp_path_factory.mktemp("data_parallel")
    jglobal, cglobal, per_rank = _global_batches()
    variables = random_variables(JAX_CFG, jglobal, seed=SEED)
    weights0 = _port_model(variables).state_dict()
    drop = _port_model(variables, dropout_rate=0.2)
    spec = {
        "dropout0": {"cfg": _port_model(variables).cfg, "weights": weights0, "seed": 3,
                     "guard": False, "steps": [per_rank]},
        "dropout02": {"cfg": drop.cfg, "weights": drop.state_dict(), "seed": 3,
                      "guard": False, "steps": [per_rank]},
        "nan": {"cfg": drop.cfg, "weights": drop.state_dict(), "seed": 3, "guard": True,
                "steps": [[per_rank[0], _poisoned(per_rank[1])], per_rank]},
    }
    spec_path = tmp / "spec.pt"
    torch.save(spec, spec_path)
    spawn_ranks(lambda rank: ["-c", WORKER, str(spec_path), str(tmp / "store"), str(rank),
                              str(tmp / f"rank{rank}.pt")])
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return {"ranks": ranks, "variables": variables, "jax_global": jglobal,
            "port_global": cglobal}


_JAX_MODEL = JaxDeepInteract(JAX_CFG)
_JAX_TX = make_optimizer(JaxOptimConfig())
_JAX_STEP = jax.jit(jax_train_step)  # one compile for the step and its reruns


def _jax_step(variables, batch):
    state = JaxTrainState.create(apply_fn=_JAX_MODEL.apply, params=variables["params"],
                                 tx=_JAX_TX, batch_stats=variables["batch_stats"],
                                 dropout_rng=jax.random.PRNGKey(0),
                                 bad_steps=jnp.zeros((), jnp.int32))
    new_state, metrics = _JAX_STEP(state, batch)
    ref = _port_model({"params": jax.tree_util.tree_map(np.asarray, new_state.params),
                       "batch_stats": jax.tree_util.tree_map(np.asarray, new_state.batch_stats)})
    return {k: float(v) for k, v in metrics.items()}, ref.state_dict()


def _spread(ref, moved_states):
    return {name: max((moved[name] - ref[name]).abs().max().item() for moved in moved_states)
            for name in ref}


def _assert_state(got, ref, spread, what):
    for name, value in ref.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=TOL["rtol"],
                                   atol=TOL["atol"] + 4 * spread[name],
                                   err_msg=f"{what}: {name}")


def test_data_parallel_step_matches_jax_on_the_global_batch(runs):
    """(c) Dropout 0: each rank's step equals JAX's single-device
    ``train_step`` on the stacked global batch of 2."""
    variables, jglobal = runs["variables"], runs["jax_global"]
    metrics, ref = _jax_step(variables, jglobal)
    moved = [_jax_step(_perturbed(variables, s), jglobal) for s in (1, 2)]
    spread = _spread(ref, [m[1] for m in moved])
    norm_spread = max(abs(m[0]["grad_norm"] - metrics["grad_norm"]) for m in moved)
    for rank, out in enumerate(runs["ranks"]):
        (res,) = out["dropout0"]
        assert out["backend"] == "gloo" and out["world"] == 2
        np.testing.assert_allclose(res["metrics"]["loss"], metrics["loss"], **LOSS_TOL)
        np.testing.assert_allclose(res["metrics"]["grad_norm"], metrics["grad_norm"],
                                   rtol=TOL["rtol"], atol=TOL["atol"] + 4 * norm_spread)
        _assert_state(res["model"], ref, spread, f"rank {rank}")
    # A mean of the ranks' own means is another number: the test can tell.
    local = [train_step(create_train_state(_port_model(variables)), b)["loss"]
             for b in _global_batches()[2]]
    assert abs(np.mean(local) - metrics["loss"]) > 1e-3


def test_data_parallel_dropout_matches_the_single_process_step(runs):
    """(d) Dropout 0.2: each rank's step equals the port's single-process
    step on the global batch (the same masks), gradients included."""
    variables, cglobal = runs["variables"], runs["port_global"]

    def single(v):
        state = create_train_state(_port_model(v, dropout_rate=0.2), seed=3)
        metrics = train_step(state, cglobal)
        return metrics, state.model.state_dict(), state.optimizer.grads().clone()

    metrics, ref, grads = single(variables)
    moved = [single(_perturbed(variables, s)) for s in (1, 2)]
    spread = _spread(ref, [m[1] for m in moved])
    grad_spread = max((m[2] - grads).abs().max().item() for m in moved)
    norm_spread = max(abs(m[0]["grad_norm"] - metrics["grad_norm"]) for m in moved)
    for rank, out in enumerate(runs["ranks"]):
        (res,) = out["dropout02"]
        np.testing.assert_allclose(res["metrics"]["loss"], metrics["loss"], **LOSS_TOL)
        np.testing.assert_allclose(res["metrics"]["grad_norm"], metrics["grad_norm"],
                                   rtol=TOL["rtol"], atol=TOL["atol"] + 4 * norm_spread)
        np.testing.assert_allclose(res["grads"].numpy(), grads.numpy(), rtol=TOL["rtol"],
                                   atol=TOL["atol"] + 4 * grad_spread)
        _assert_state(res["model"], ref, spread, f"rank {rank}")
    # Dropout is on: the step differs from the dropout-0 one.
    assert runs["ranks"][0]["dropout02"][0]["metrics"]["loss"] != \
        runs["ranks"][0]["dropout0"][0]["metrics"]["loss"]


def test_a_non_finite_batch_on_one_rank_skips_the_step_on_every_rank(runs):
    """(e) A NaN batch on rank 1 only: both ranks report the skip, keep the
    state bitwise as it was and equal, then take the next step together."""
    variables = runs["variables"]
    start = [t.clone() for t in create_train_state(
        _port_model(variables, dropout_rate=0.2), seed=3).tensors()]
    (bad0, good0), (bad1, good1) = runs["ranks"][0]["nan"], runs["ranks"][1]["nan"]
    for bad in (bad0, bad1):
        assert bad["metrics"]["bad_step"] == 1.0 and bad["metrics"]["bad_steps"] == 1.0
        assert not np.isfinite(bad["metrics"]["loss"])
        # Every tensor but the skip counter (the last) as it was.
        assert all(torch.equal(a, b) for a, b in zip(bad["tensors"][:-1], start[:-1]))
    for good in (good0, good1):
        assert good["metrics"]["bad_step"] == 0.0 and good["metrics"]["bad_steps"] == 0.0
    for a, b in ((bad0, bad1), (good0, good1)):
        assert np.array_equal(list(a["metrics"].values()), list(b["metrics"].values()),
                              equal_nan=True)
        assert all(torch.equal(x, y) for x, y in zip(a["tensors"], b["tensors"]))
        assert all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
    assert not torch.equal(good0["model"]["decoder.phase2_conv.weight"],
                           bad0["model"]["decoder.phase2_conv.weight"])


def test_the_step_all_reduces_are_counted_by_site(runs):
    """One gradient reduce, two for the loss (the weight sum and the
    reported loss), two per train-mode batch-norm call and two for their
    backward: the numbers a captured step must hold."""
    for out in runs["ranks"]:
        for name in ("dropout0", "dropout02", "nan"):
            for res in out[name]:
                n = res["bn_calls"]
                assert n > 0
                assert res["reduces"] == {"grads": 1, "loss": 2, "batch_norm": 2 * n,
                                          "batch_norm_grad": 2 * n}, (name, res["reduces"])


def _tiny_tree(root):
    from deepinteract_tpu_torch.data.synthetic import write_tiny_npz_dataset

    write_tiny_npz_dataset(str(root), n_complexes=5, seed=0)


TINY_FLAGS = ["--num_gnn_layers", "1", "--num_gnn_hidden_channels", "8",
              "--num_gnn_attention_heads", "2", "--num_interact_layers", "1",
              "--num_interact_hidden_channels", "8", "--num_epochs", "1",
              "--steps_per_dispatch", "1", "--log_every", "1", "--seed", "7",
              "--device", "cpu", "--heartbeat_seconds", "0.2"]


def _epoch_line(out: str) -> str:
    lines = [line for line in out.splitlines() if line.startswith("epoch 0:")]
    assert lines, out[-2000:]
    return re.sub(r" (?:train|val)_s=[0-9.]+", "", lines[-1])


def test_two_process_cli_train(tmp_path):
    """(f) ``cli.train --num_processes 2 --device cpu``: 5 same-bucket
    complexes at global batch 2 (1 local x 2) give 2 coordinated steps;
    both ranks print the same epoch line; rank 0 alone writes checkpoints,
    the CSV and the metrics line; each rank beats its own heartbeat."""
    root = tmp_path / "data"
    _tiny_tree(root)
    store = tmp_path / "store"

    def argv(rank):
        work = tmp_path / f"host{rank}"
        work.mkdir()
        return ["-m", "deepinteract_tpu_torch.cli.train", "--dips_root", str(root),
                "--ckpt_dir", str(work / "ckpt"), "--test_csv", str(work / "test.csv"),
                "--coordinator_address", f"file://{store}", "--num_processes", "2",
                "--process_id", str(rank), *TINY_FLAGS]

    outs = spawn_ranks(argv)
    for rank, out in enumerate(outs):
        m = re.search(rf"host {rank}/2: (\d+) coordinated global steps", out)
        assert m and int(m.group(1)) == 2, out[-2000:]
        assert len(re.findall(r"epoch 0 step \d+: loss=", out)) == 2, out[-2000:]
    assert _epoch_line(outs[0]) == _epoch_line(outs[1])
    assert outs[0].rstrip().splitlines()[-1].startswith("{'")
    assert not outs[1].rstrip().splitlines()[-1].startswith("{")
    host0, host1 = tmp_path / "host0", tmp_path / "host1"
    assert (host0 / "ckpt" / "best").is_dir() and (host0 / "test.csv").exists()
    assert not (host1 / "ckpt" / "best").exists() and not (host1 / "ckpt" / "last").exists()
    assert not (host1 / "test.csv").exists()
    assert (host0 / "ckpt" / "obs" / "heartbeat_p0.json").exists()
    assert (host1 / "ckpt" / "obs" / "heartbeat_p1.json").exists()
    assert not (host1 / "ckpt" / "obs" / "events.jsonl").exists()


# One rank of the Trainer over its slice of the same global batches:
# an uninterrupted 2-epoch fit with SWA; the same fit cut after epoch 0
# and resumed (rank 0 alone holds the checkpoint); and a fit that a
# preemption on rank 1 alone stops at the next epoch boundary.
TRAINER_WORKER = r"""
import sys
import torch
torch.set_num_threads(1)
from deepinteract_tpu_torch.models.model import DeepInteract
from deepinteract_tpu_torch.parallel import mesh as mesh_lib, multihost
from deepinteract_tpu_torch.robustness import faults
from deepinteract_tpu_torch.robustness.preemption import TrainingPreempted
from deepinteract_tpu_torch.training.loop import LoopConfig, Trainer
from deepinteract_tpu_torch.training.optim import OptimConfig

spec_path, store, rank, work, out_path = (sys.argv[1], sys.argv[2], int(sys.argv[3]),
                                          sys.argv[4], sys.argv[5])
spec = torch.load(spec_path, weights_only=False)
multihost.initialize_distributed(f"file://{store}", 2, rank, device="cpu", timeout_s=120)
mesh = mesh_lib.make_mesh()
train = [b[rank] for b in spec["batches"]]
logs = []

def fit(name, epochs, resume=False, **loop):
    model = DeepInteract(spec["cfg"])
    model.load_state_dict(spec["weights"])
    cfg = LoopConfig(num_epochs=2, log_every=0, seed=3, ckpt_dir=f"{work}/{name}",
                     async_checkpoint=False, span_log=False, **loop)
    trainer = Trainer(model, cfg, OptimConfig(steps_per_epoch=2, num_epochs=2),
                      log_fn=logs.append, mesh=mesh)
    state, history = trainer.fit(trainer.init_state(), train, val_data=spec["val"],
                                 num_epochs=epochs, resume=resume)
    return {"tensors": [t.clone() for t in state.tensors()],
            "model": {k: v.clone() for k, v in model.state_dict().items()},
            "history": [{k: v for k, v in h.items() if "seconds" not in k
                         and not k.startswith("tele_")} for h in history]}

out = {"whole": fit("whole", 2, swa=True, swa_epoch_start=0.5)}
fit("cut", 1, swa=True, swa_epoch_start=0.5)
out["resumed"] = fit("cut", 2, resume=True, swa=True, swa_epoch_start=0.5)
if rank == 1:
    faults.configure("train.sigterm=@1")
try:
    fit("preempted", 2)
    out["preempted"] = None
except TrainingPreempted as exc:
    out["preempted"] = str(exc)
faults.reset()
out["logs"] = logs
torch.save(out, out_path)
multihost.exit_barrier()
"""


def test_trainer_resume_preemption_and_swa_across_two_ranks(tmp_path):
    """Rank 0 alone checkpoints, and a resume broadcasts its state into
    rank 1's tensors: the resumed run ends bitwise equal to the
    uninterrupted one on both ranks, SWA's batch statistics included; a
    preemption requested on rank 1 alone stops both ranks at the next
    epoch boundary."""
    _, _, per_rank = _global_batches()
    variables = random_variables(JAX_CFG, _global_batches()[0], seed=SEED)
    model = _port_model(variables, dropout_rate=0.1)
    spec = {"cfg": model.cfg, "weights": model.state_dict(),
            "batches": [per_rank, per_rank[::-1]], "val": per_rank[:1]}
    torch.save(spec, tmp_path / "spec.pt")
    spawn_ranks(lambda rank: ["-c", TRAINER_WORKER, str(tmp_path / "spec.pt"),
                              str(tmp_path / "store"), str(rank), str(tmp_path / f"w{rank}"),
                              str(tmp_path / f"rank{rank}.pt")])
    outs = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    for out in outs:
        whole, resumed = out["whole"], out["resumed"]
        assert [h["epoch"] for h in whole["history"]] == [0, 1]
        assert resumed["history"] == whole["history"][1:]
        assert all(torch.equal(a, b) for a, b in zip(whole["tensors"], resumed["tensors"]))
        assert all(torch.equal(whole["model"][k], resumed["model"][k]) for k in whole["model"])
        assert out["preempted"] is not None
    assert any("resumed from epoch 1" in line for line in outs[0]["logs"])
    for key in ("whole", "resumed"):
        assert all(torch.equal(a, b) for a, b in zip(outs[0][key]["tensors"],
                                                     outs[1][key]["tensors"]))
        assert outs[0][key]["history"] == outs[1][key]["history"]
    assert "peer rank" in outs[0]["preempted"] and "fault plan" in outs[1]["preempted"]
    assert (tmp_path / "w0" / "cut" / "last").is_dir()
    assert not (tmp_path / "w1" / "cut").exists()
