"""Pair-map sharding over torch.distributed (``parallel/pair.py`` and the
pair axis of ``parallel/mesh.py``) on gloo ranks, against the JAX
package's ``shard_pair_map`` on a ``(data, pair)`` mesh of the virtual CPU
devices and against the port's one-process path.

One module-scoped spawn per grid shape, each rank a ``python -c`` process
with torch on one thread, meeting at a FileStore under the test's
directory:

* P = 2: the model's decode of a complex's rows (dilation cycle
  (1, 2, 4, 8), regional attention off and on, and the attention's
  dropout on) with its input and parameter gradients, and a tiled eval
  step (a 64 x 64 map in 32-tiles);
* D x P = 2 x 2: one train step per rank on its data index's complex,
  with dropout 0 (against JAX's sharded step) and 0.2 (against the port's
  one-process step on the global batch).

Bars: logits 1e-4; gradients, parameters and batch statistics 1e-4 plus
four times the reference's own spread (its largest move when every weight
moves by 1e-7 relative; ROADMAP queue 3); tiled logits rtol 4e-4 / atol
1e-4 (the tiled tier's bar). Unshardable configurations raise before any
collective, and ``cli.train --num_devices 1 --num_pair_shards 2`` ends
where the one-process run ends.
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
from deepinteract_tpu.parallel import make_mesh as jax_make_mesh
from deepinteract_tpu.parallel import make_sharded_train_step as jax_sharded_train_step
from deepinteract_tpu.parallel import mesh_context, replicate, shard_batch
from deepinteract_tpu.training.optim import OptimConfig as JaxOptimConfig
from deepinteract_tpu.training.optim import make_optimizer
from deepinteract_tpu.training.steps import TrainState as JaxTrainState
from deepinteract_tpu_torch.data.graph import stack_complexes
from deepinteract_tpu_torch.data.synthetic import random_complex
from deepinteract_tpu_torch.models.layers import DropoutKey, dropout_rng
from deepinteract_tpu_torch.models.model import DeepInteract
from deepinteract_tpu_torch.parallel.pair import PairMesh, pair_sharded
from deepinteract_tpu_torch.training.steps import create_train_state, eval_step, train_step
from deepinteract_tpu_torch.weights import load_jax_variables
from torch_port_helpers import KNN, PAD, jax_cfg, port_cfg, random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240
TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
TILED_TOL = dict(rtol=4e-4, atol=1e-4)
SIZES = ((26, 22), (20, 17))  # one bucket (padded to 32), unequal valid pairs
SEED = 11
MOVED_SEEDS = (1, 2, 3, 4)

# One rank of a grid: every scenario of its shape; writes its results.
WORKER = r"""
import sys
import torch
torch.set_num_threads(1)
from deepinteract_tpu_torch.models.layers import DropoutKey, dropout_rng
from deepinteract_tpu_torch.models.model import DeepInteract
from deepinteract_tpu_torch.parallel import mesh as mesh_lib, multihost
from deepinteract_tpu_torch.parallel.pair import pair_sharded, take_rows
from deepinteract_tpu_torch.parallel.train import make_sharded_train_step
from deepinteract_tpu_torch.training.steps import create_train_state, eval_step

spec_path, store, rank, out_path = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]
spec = torch.load(spec_path, weights_only=False)
multihost.initialize_distributed(f"file://{store}", spec["world"], rank, device="cpu",
                                 timeout_s=120)
mesh = mesh_lib.make_mesh(num_pair=spec["pairs"], shard_pair_map=True)
out = {"pair_index": mesh.pair.index, "data_rank": mesh.data_rank}


def counted(fn):
    before = dict(mesh_lib.ALL_REDUCES)
    value = fn()
    return value, {k: v - before.get(k, 0) for k, v in mesh_lib.ALL_REDUCES.items()
                   if v != before.get(k, 0)}


for name, sc in spec.get("decode", {}).items():
    model = DeepInteract(sc["cfg"])
    model.load_state_dict(sc["weights"])
    model.train(sc["train"])
    f1, f2 = sc["f1"].clone().requires_grad_(), sc["f2"].clone().requires_grad_()
    rows = model.pair_row_slices(f1.shape[1], f2.shape[1], mesh.pair)
    with dropout_rng(model, DropoutKey(torch.tensor(5), torch.tensor(3))), \
            pair_sharded(mesh.pair):
        logits, reduces = counted(lambda: model.decode(f1, f2, sc["m1"], sc["m2"]))
        (logits * take_rows(sc["cot"], rows)).sum().backward()
    out[name] = {"rows": rows, "logits": logits.detach(), "reduces": reduces,
                 "g1": f1.grad, "g2": f2.grad,
                 "params": {n: p.grad.clone() for n, p in model.named_parameters()
                            if p.grad is not None}}

for name, sc in spec.get("eval", {}).items():
    model = DeepInteract(sc["cfg"])
    model.load_state_dict(sc["weights"])
    outs, reduces = counted(lambda: eval_step(create_train_state(model), sc["batch"],
                                              mesh=mesh))
    out[name] = {"loss": outs["loss"], "logits": outs["logits"], "reduces": reduces}

for name, sc in spec.get("train", {}).items():
    model = DeepInteract(sc["cfg"])
    model.load_state_dict(sc["weights"])
    state = create_train_state(model, seed=sc["seed"])
    step = make_sharded_train_step(mesh)
    metrics, reduces = counted(lambda: step(state, sc["batches"][mesh.data_rank]))
    out[name] = {"metrics": metrics, "reduces": reduces,
                 "grads": state.optimizer.grads().clone(),
                 "model": {k: v.clone() for k, v in model.state_dict().items()}}
torch.save(out, out_path)
multihost.exit_barrier()
"""


def spawn(spec, tmp, world):
    """Run ``world`` ranks of :data:`WORKER` on ``spec``; their results."""
    spec = dict(spec, world=world)
    torch.save(spec, tmp / "spec.pt")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(tmp / "spec.pt"),
                               str(tmp / "store"), str(rank), str(tmp / f"rank{rank}.pt")],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for rank in range(world)]
    for rank, proc in enumerate(procs):
        try:
            out, _ = proc.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            pytest.fail(f"rank {rank} timed out:\n{proc.communicate()[0][-4000:]}")
        assert proc.returncode == 0, f"rank {rank} failed:\n{out[-6000:]}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _shallow(cfg, **decoder):
    return dataclasses.replace(cfg, gnn=dataclasses.replace(cfg.gnn, num_layers=1),
                               decoder=dataclasses.replace(cfg.decoder, num_chunks=1,
                                                           **decoder))


def _port_cfg(attention=False, dropout=0.0, **kw):
    cfg = _shallow(port_cfg(**kw), use_attention=attention, dropout_rate=dropout)
    return dataclasses.replace(cfg, gnn=dataclasses.replace(cfg.gnn, dropout_rate=dropout))


def _jax_cfg(attention=False, shard=True):
    cfg = _shallow(jax_cfg(), use_attention=attention, dropout_rate=0.0)
    return dataclasses.replace(cfg, shard_pair_map=shard)


def _perturbed(variables, seed):
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) * (1 + 1e-7 * rng.standard_normal(a.shape)).astype(np.float32),
        variables["params"])
    return dict(variables, params=params)


def _port_model(cfg, variables):
    model = DeepInteract(cfg)
    load_jax_variables(model, variables)
    return model


def _batches(pad=PAD, sizes=SIZES):
    """(JAX global batch, port global batch, port per-data-rank batches)."""
    jcx = [jax_random_complex(n1, n2, np.random.default_rng(SEED + i), n_pad1=pad,
                              n_pad2=pad, knn=KNN) for i, (n1, n2) in enumerate(sizes)]
    cx = [random_complex(n1, n2, np.random.default_rng(SEED + i), n_pad1=pad, n_pad2=pad,
                         knn=KNN) for i, (n1, n2) in enumerate(sizes)]
    return jax_stack(jcx), stack_complexes(cx), [stack_complexes([c]) for c in cx]


def _whole(ranks, name, key):
    """A rank-sharded output put back together: each rank's rows in place."""
    first = ranks[0][name][key]
    out = torch.zeros((first.shape[0], sum(r[name][key].shape[1] for r in ranks),
                       *first.shape[2:]), dtype=first.dtype)
    for r in ranks:
        start = 0
        for s in r[name]["rows"]:
            n = s.stop - s.start
            out[:, s] = r[name][key][:, start:start + n]
            start += n
    return out


# ---------------------------------------------------------------------------
# (a) decode and (c) tiled eval at P = 2
# ---------------------------------------------------------------------------

DECODES = {"plain": dict(attention=False), "attention": dict(attention=True),
           "attention_dropout": dict(attention=True, dropout=0.2)}


@pytest.fixture(scope="module")
def pair2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pair2")
    jglobal, cglobal, _ = _batches()
    rng = np.random.default_rng(SEED)
    b, l1, l2 = cglobal.contact_map.shape
    feats = {"f1": rng.standard_normal((b, l1, 16)).astype(np.float32),
             "f2": rng.standard_normal((b, l2, 16)).astype(np.float32),
             "cot": rng.standard_normal((b, l1, l2, 2)).astype(np.float32)}
    variables = {att: random_variables(_jax_cfg(att, shard=False), jglobal, seed=SEED)
                 for att in (False, True)}
    decode = {}
    for name, kw in DECODES.items():
        cfg = dataclasses.replace(_port_cfg(**kw), shard_pair_map=True)
        decode[name] = {"cfg": cfg, "train": "dropout" in kw,
                        "weights": _port_model(cfg, variables[kw["attention"]]).state_dict(),
                        **{k: torch.from_numpy(v) for k, v in feats.items()},
                        "m1": cglobal.graph1.node_mask, "m2": cglobal.graph2.node_mask}
    tiled_j, tiled_c, _ = _batches(pad=64, sizes=((58, 45),))
    tiled_cfg = dataclasses.replace(_port_cfg(attention=True), tile_pair_map=True,
                                    tile_size=32, shard_pair_map=True)
    tiled_vars = random_variables(_jax_cfg(True, shard=False), tiled_j, seed=SEED)
    evals = {"tiled": {"cfg": tiled_cfg, "batch": tiled_c,
                       "weights": _port_model(tiled_cfg, tiled_vars).state_dict()}}
    ranks = spawn({"pairs": 2, "decode": decode, "eval": evals}, tmp, world=2)
    return {"ranks": ranks, "variables": variables, "feats": feats, "decode": decode,
            "evals": evals}


def _port_decode(sc, weights=None):
    """The port's one-process decode of a scenario: logits, input and
    parameter gradients."""
    cfg = dataclasses.replace(sc["cfg"], shard_pair_map=False)
    model = DeepInteract(cfg)
    model.load_state_dict(weights or sc["weights"])
    model.train(sc["train"])
    f1, f2 = sc["f1"].clone().requires_grad_(), sc["f2"].clone().requires_grad_()
    with dropout_rng(model, DropoutKey(torch.tensor(5), torch.tensor(3))):
        logits = model.decode(f1, f2, sc["m1"], sc["m2"])
        (logits * sc["cot"]).sum().backward()
    return logits.detach(), f1.grad, f2.grad, {n: p.grad for n, p in model.named_parameters()
                                               if p.grad is not None}


_JAX_DECODE = {}


def _jax_decode(attention, variables, feats, masks):
    """JAX's decode under ``shard_pair_map`` on a 1 x 2 mesh: logits and the
    input gradients of the same cotangent."""
    if attention not in _JAX_DECODE:
        model = JaxDeepInteract(_jax_cfg(attention))

        def loss(v, f1, f2, m1, m2, cot):
            out = model.apply(v, f1, f2, m1, m2, method=JaxDeepInteract.decode)
            return (out * cot).sum(), out

        _JAX_DECODE[attention] = jax.jit(jax.value_and_grad(loss, argnums=(1, 2),
                                                            has_aux=True))
    with mesh_context(jax_make_mesh(num_data=1, num_pair=2)):
        (_, logits), (g1, g2) = _JAX_DECODE[attention](
            variables, feats["f1"], feats["f2"], *masks, feats["cot"])
    return np.asarray(logits), np.asarray(g1), np.asarray(g2)


@pytest.mark.parametrize("name", ["plain", "attention"])
def test_sharded_decode_matches_jax_and_the_one_process_decode(pair2, name):
    """(a) P = 2, dilations (1, 2, 4, 8): the ranks' rows put together equal
    JAX's sharded decode and the port's one-process decode at 1e-4; the
    input gradients summed over the ranks equal both within 1e-4 plus
    four times JAX's spread, the parameter gradients the port's."""
    ranks, sc = pair2["ranks"], pair2["decode"][name]
    attention = DECODES[name]["attention"]
    variables = pair2["variables"][attention]
    masks = (jnp.asarray(sc["m1"].numpy()), jnp.asarray(sc["m2"].numpy()))
    jl, jg1, jg2 = _jax_decode(attention, variables, pair2["feats"], masks)
    moved = [_jax_decode(attention, _perturbed(variables, s), pair2["feats"], masks)
             for s in MOVED_SEEDS[:2]]
    spread = [max(np.abs(m[i] - ref).max() for m in moved) for i, ref in ((1, jg1), (2, jg2))]
    logits = _whole(ranks, name, "logits")
    g1 = sum(r[name]["g1"] for r in ranks)
    g2 = sum(r[name]["g2"] for r in ranks)
    pl, pg1, pg2, pparams = _port_decode(sc)
    np.testing.assert_allclose(logits.numpy(), jl, **TOL)
    np.testing.assert_allclose(logits.numpy(), pl.numpy(), **TOL)
    for got, jref, pref, s in ((g1, jg1, pg1, spread[0]), (g2, jg2, pg2, spread[1])):
        np.testing.assert_allclose(got.numpy(), jref, rtol=TOL["rtol"], atol=TOL["atol"] + 4 * s)
        np.testing.assert_allclose(got.numpy(), pref.numpy(), rtol=TOL["rtol"],
                                   atol=TOL["atol"] + 4 * s)
    for pname, grad in pparams.items():
        got = sum(r[name]["params"][pname] for r in ranks)
        np.testing.assert_allclose(got.numpy(), grad.numpy(), err_msg=pname, rtol=TOL["rtol"],
                                   atol=TOL["atol"] + 4 * max(spread))
    # Each rank holds 16 of the 32 rows: the halo of dilation 8 fits.
    assert [r[name]["rows"] for r in ranks] == [[slice(0, 16)], [slice(16, 32)]]
    red = ranks[0][name]["reduces"]
    halos = 10 + (2 if attention else 0)  # a 3x3 per block, one per attention stage
    assert red == {"halo": halos, "pair_norm": 2 * 13, "pair_se": 10}, red


def test_sharded_attention_dropout_draws_the_one_process_masks(pair2):
    """(a) Train-mode regional attention with dropout 0.2: every rank hashes
    its elements' rows of the whole map, so the sharded decode and its
    gradients equal the one-process decode's with the same key."""
    ranks, sc = pair2["ranks"], pair2["decode"]["attention_dropout"]
    pl, pg1, pg2, _ = _port_decode(sc)
    plain, *_ = _port_decode(pair2["decode"]["attention"])
    logits = _whole(ranks, "attention_dropout", "logits")
    np.testing.assert_allclose(logits.numpy(), pl.numpy(), **TOL)
    np.testing.assert_allclose(sum(r["attention_dropout"]["g1"] for r in ranks).numpy(),
                               pg1.numpy(), **TOL)
    np.testing.assert_allclose(sum(r["attention_dropout"]["g2"] for r in ranks).numpy(),
                               pg2.numpy(), **TOL)
    assert not torch.allclose(pl, plain, atol=1e-3)  # the masks did drop


def test_tiled_sharded_eval_matches_the_unsharded_tiled_eval(pair2):
    """(c) A 64 x 64 map in 32-tiles with attention, P = 2: each tile's rows
    split over the ranks; the eval step's gathered logits and its loss equal
    the one-process tiled eval on every rank."""
    sc = pair2["evals"]["tiled"]
    model = DeepInteract(dataclasses.replace(sc["cfg"], shard_pair_map=False))
    model.load_state_dict(sc["weights"])
    ref = eval_step(create_train_state(model), sc["batch"])
    for r in pair2["ranks"]:
        got = r["tiled"]
        np.testing.assert_allclose(got["logits"].numpy(), ref["logits"].numpy(), **TILED_TOL)
        np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]), **LOSS_TOL)
        # Four tiles: per tile 12 halos; the loss's two sums and one gather.
        assert got["reduces"]["halo"] == 4 * 12 and got["reduces"]["pair_gather"] == 1
        assert got["reduces"]["pair_loss"] == 2


# ---------------------------------------------------------------------------
# (b) one train step at D x P = 2 x 2
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grid22(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("grid22")
    jglobal, cglobal, per_rank = _batches()
    variables = random_variables(_jax_cfg(True, shard=False), jglobal, seed=SEED)
    train = {}
    for name, dropout in (("dropout0", 0.0), ("dropout02", 0.2)):
        cfg = dataclasses.replace(_port_cfg(attention=True, dropout=dropout),
                                  shard_pair_map=True)
        train[name] = {"cfg": cfg, "weights": _port_model(cfg, variables).state_dict(),
                       "seed": 3, "batches": per_rank}
    ranks = spawn({"pairs": 2, "train": train}, tmp, world=4)
    return {"ranks": ranks, "variables": variables, "jax_global": jglobal,
            "port_global": cglobal, "train": train}


_JAX_STEP = {}


def _jax_sharded_step(variables, batch):
    """JAX's sharded train step on a 2 x 2 (data x pair) mesh: its metrics and
    its new state on the port's names."""
    mesh = jax_make_mesh(num_data=2, num_pair=2)
    if "step" not in _JAX_STEP:
        _JAX_STEP["model"] = JaxDeepInteract(_jax_cfg(True))
        _JAX_STEP["step"] = jax_sharded_train_step(mesh, donate=False)
    model = _JAX_STEP["model"]
    with mesh_context(mesh):
        state = JaxTrainState.create(apply_fn=model.apply, params=variables["params"],
                                     tx=make_optimizer(JaxOptimConfig()),
                                     batch_stats=variables["batch_stats"],
                                     dropout_rng=jax.random.PRNGKey(0),
                                     bad_steps=jnp.zeros((), jnp.int32))
        new_state, metrics = _JAX_STEP["step"](replicate(state, mesh), shard_batch(batch, mesh))
    ref = _port_model(_port_cfg(attention=True), {
        "params": jax.tree_util.tree_map(np.asarray, new_state.params),
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


def test_2x2_train_step_matches_jax_sharded_step(grid22):
    """(b) Dropout 0: every rank's step equals JAX's step on a 2 x 2 mesh
    (``shard_pair_map``): the loss at 1e-5, the grad norm, parameters and
    batch statistics within 1e-4 plus four times JAX's own spread."""
    variables, jglobal = grid22["variables"], grid22["jax_global"]
    metrics, ref = _jax_sharded_step(variables, jglobal)
    moved = [_jax_sharded_step(_perturbed(variables, s), jglobal) for s in MOVED_SEEDS]
    spread = _spread(ref, [m[1] for m in moved])
    norm_spread = max(abs(m[0]["grad_norm"] - metrics["grad_norm"]) for m in moved)
    for rank, out in enumerate(grid22["ranks"]):
        res = out["dropout0"]
        np.testing.assert_allclose(res["metrics"]["loss"], metrics["loss"], **LOSS_TOL)
        np.testing.assert_allclose(res["metrics"]["grad_norm"], metrics["grad_norm"],
                                   rtol=TOL["rtol"], atol=TOL["atol"] + 4 * norm_spread)
        _assert_state(res["model"], ref, spread, f"rank {rank}")


def test_2x2_train_step_with_dropout_matches_the_one_process_step(grid22):
    """(b) Dropout 0.2 (encoder and regional attention): every rank's step
    equals the port's one-process step on the global batch of 2, the
    flat gradient included, within 1e-4 plus four times the port's own
    spread; the four ranks end bitwise equal."""
    sc = grid22["train"]["dropout02"]
    cglobal = grid22["port_global"]

    def single(weights):
        model = DeepInteract(dataclasses.replace(sc["cfg"], shard_pair_map=False))
        model.load_state_dict(weights)
        state = create_train_state(model, seed=sc["seed"])
        metrics = train_step(state, cglobal)
        return metrics, state.model.state_dict(), state.optimizer.grads().clone()

    def moved_weights(seed):
        rng = np.random.default_rng(seed)
        return {k: (v * (1 + 1e-7 * torch.from_numpy(rng.standard_normal(v.shape)
                                                     .astype(np.float32)))
                    if v.is_floating_point() and "running" not in k else v)
                for k, v in sc["weights"].items()}

    metrics, ref, grads = single(sc["weights"])
    moved = [single(moved_weights(s)) for s in MOVED_SEEDS]
    spread = _spread(ref, [m[1] for m in moved])
    grad_spread = max((m[2] - grads).abs().max().item() for m in moved)
    norm_spread = max(abs(m[0]["grad_norm"] - metrics["grad_norm"]) for m in moved)
    ranks = grid22["ranks"]
    for rank, out in enumerate(ranks):
        res = out["dropout02"]
        np.testing.assert_allclose(res["metrics"]["loss"], metrics["loss"], **LOSS_TOL)
        np.testing.assert_allclose(res["metrics"]["grad_norm"], metrics["grad_norm"],
                                   rtol=TOL["rtol"], atol=TOL["atol"] + 4 * norm_spread)
        np.testing.assert_allclose(res["grads"].numpy(), grads.numpy(), rtol=TOL["rtol"],
                                   atol=TOL["atol"] + 4 * grad_spread)
        _assert_state(res["model"], ref, spread, f"rank {rank}")
        for k, v in res["model"].items():
            assert torch.equal(v, ranks[0]["dropout02"]["model"][k]), (rank, k)
    assert [(r["data_rank"], r["pair_index"]) for r in ranks] == [(0, 0), (0, 1), (1, 0),
                                                                  (1, 1)]
    assert ranks[0]["dropout02"]["metrics"]["loss"] != ranks[0]["dropout0"]["metrics"]["loss"]


def test_2x2_train_step_collectives_by_site(grid22):
    """The collectives a captured 2 x 2 step holds, by site: the gradient
    and loss sums over the world, two per encoder batch norm (and its
    backward) over the data group, and on the pair group a halo per 3x3
    (10) and per attention stage (2), two statistics per instance norm
    (13) and one per squeeze-excitation (10), each with its backward."""
    for out in grid22["ranks"]:
        for name in ("dropout0", "dropout02"):
            red = out[name]["reduces"]
            n = red["batch_norm"] // 2
            assert n > 0 and red["batch_norm_grad"] == 2 * n
            assert {k: v for k, v in red.items() if not k.startswith("batch_norm")} == {
                "grads": 1, "loss": 2, "halo": 12, "halo_grad": 12, "pair_norm": 26,
                "pair_norm_grad": 26, "pair_se": 10, "pair_se_grad": 10}, red


# ---------------------------------------------------------------------------
# (d) what cannot be sharded raises
# ---------------------------------------------------------------------------

def _lone_pair(size=2):
    """A pair mesh with no group: row checks run before any collective."""
    return PairMesh(0, size, None, tuple(range(size)), torch.device("cpu"))


def test_unshardable_configurations_raise():
    """DeepLab (naming its ROADMAP item), rows that the pair axis does not
    divide and shards narrower than the decoder's halo raise (each saying
    what to change); a sharded model without a pair mesh raises instead of
    decoding unsharded."""
    with pytest.raises(ValueError, match="DeepLab.*queue 1 item 2"):
        port_cfg(interact_module_type="deeplab", shard_pair_map=True)
    model = DeepInteract(dataclasses.replace(_port_cfg(), shard_pair_map=True))
    with pytest.raises(ValueError, match="do not split over 3.*pair axis that divides"):
        model.pair_row_slices(32, 32, _lone_pair(3))
    with pytest.raises(ValueError, match="narrower than the decoder's halo of 8.*fewer pair"):
        model.pair_row_slices(32, 32, _lone_pair(8))  # 4 rows, dilation 8
    tiled = DeepInteract(dataclasses.replace(_port_cfg(), shard_pair_map=True,
                                             tile_pair_map=True, tile_size=32))
    with pytest.raises(ValueError, match="narrower"):
        tiled.pair_row_slices(64, 64, _lone_pair(8))  # 32-row tiles over 8 shards
    _, cglobal, _ = _batches()
    with pytest.raises(RuntimeError, match="pair group"):
        model(cglobal.graph1, cglobal.graph2)
    with pair_sharded(_lone_pair(8)), pytest.raises(ValueError, match="narrower"):
        model(cglobal.graph1, cglobal.graph2)
    assert model.pair_row_slices(64, 32, _lone_pair(2)) == [slice(0, 32)]
    assert tiled.pair_row_slices(64, 64, _lone_pair(2)) == [slice(0, 16), slice(32, 48)]


# ---------------------------------------------------------------------------
# (e) cli.train over a pair axis of 2
# ---------------------------------------------------------------------------

TINY_FLAGS = ["--num_gnn_layers", "1", "--num_gnn_hidden_channels", "8",
              "--num_gnn_attention_heads", "2", "--num_interact_layers", "1",
              "--num_interact_hidden_channels", "8", "--num_epochs", "1",
              "--steps_per_dispatch", "1", "--log_every", "1", "--seed", "7",
              "--device", "cpu", "--lr", "1e-3"]


def _numbers(line):
    return [float(x) for x in re.findall(r"=(-?[0-9.]+(?:e-?\d+)?)", line)]


def _cli(module, *argv):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", f"deepinteract_tpu_torch.cli.{module}",
                           *argv], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """``cli.train`` on a tiny tree, one process and over two pair shards."""
    from deepinteract_tpu_torch.data.synthetic import write_tiny_npz_dataset

    tmp = tmp_path_factory.mktemp("cli")
    root = tmp / "data"
    write_tiny_npz_dataset(str(root), n_complexes=5, seed=0)
    outs = {name: _cli("train", "--dips_root", str(root), "--ckpt_dir", str(tmp / name / "ckpt"),
                       "--test_csv", str(tmp / name / "test.csv"), *TINY_FLAGS, *extra)
            for name, extra in (("one", []), ("pair2", ["--num_devices", "1",
                                                        "--num_pair_shards", "2"]))}
    return tmp, root, outs


def test_cli_train_over_two_pair_shards_equals_the_one_process_run(cli_runs):
    """(e) ``cli.train --num_devices 1 --num_pair_shards 2 --device cpu``
    (rank 0 starts rank 1): the per-step losses and the validation and test
    cross entropies equal the one-process run's to the printed precision
    (one unit of the last digit), and the last/ weights within the five
    AdamW steps' bound of 2 * lr each (the JAX package's bar for a sharded
    step, ``tests/test_parallel.py``)."""
    from deepinteract_tpu_torch.cli.args import model_config_from_args
    from deepinteract_tpu_torch.cli.train import parse_args
    from deepinteract_tpu_torch.training.checkpoint import CheckpointConfig, Checkpointer

    tmp_path, root, outs = cli_runs
    # Both ranks of the pair run log every step and the epoch line (their
    # lines interleave); rank 0 alone prints the test metrics.
    pattern = r"(?:step \d+: loss=|val_ce=|'test_ce': )([0-9.]+)"
    one = [float(x) for x in re.findall(pattern, outs["one"])]
    pair2 = [float(x) for x in re.findall(pattern, outs["pair2"])]
    assert len(one) == 5 + 1 + 1 and len(pair2) == 2 * 6 + 1
    np.testing.assert_allclose(sorted(pair2), sorted(one + one[:-1]), atol=1.01e-4, rtol=0)

    cfg = model_config_from_args(parse_args(["--dips_root", str(root), *TINY_FLAGS]))

    def last(name):
        model = DeepInteract(cfg)
        state = create_train_state(model)
        Checkpointer(CheckpointConfig(directory=str(tmp_path / name / "ckpt"))).restore(
            state, which="last", partial=True)
        return model.state_dict()

    pair = last("pair2")
    for k, v in last("one").items():
        np.testing.assert_allclose(pair[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-4 + 2 * 1e-3 * 5, err_msg=k)
    assert not list((tmp_path / "pair2" / "ckpt").glob(".rendezvous-*"))


def test_cli_test_over_a_2x2_grid_equals_the_one_process_test(cli_runs, tmp_path):
    """``cli.test --num_devices 2 --num_pair_shards 2 --device cpu`` on the
    one-process run's checkpoint: four ranks (evaluation replicated over the
    data axis, each map's rows over the pair axis, gathered whole) print the
    one-process test's metrics within 2e-6 and write the same CSV rows;
    rank 0 alone reports."""
    work, root, _ = cli_runs
    common = ["--dips_root", str(root), "--ckpt_name", str(work / "one" / "ckpt"),
              *TINY_FLAGS]
    one = _cli("test", *common, "--csv_out", str(tmp_path / "one.csv"),
               "--ckpt_dir", str(tmp_path / "one"))
    grid = _cli("test", *common, "--csv_out", str(tmp_path / "grid.csv"),
                "--ckpt_dir", str(tmp_path / "grid"), "--num_devices", "2",
                "--num_pair_shards", "2")

    def metrics(out):
        return {k: float(v) for k, v in re.findall(r"^(\w+): (-?[0-9.]+)$", out, re.M)}

    assert metrics(one) and metrics(grid).keys() == metrics(one).keys()
    for k, v in metrics(one).items():
        assert abs(metrics(grid)[k] - v) <= 2e-6, (k, metrics(grid)[k], v)
    assert grid.count("wrote ") == 1
    rows = [open(tmp_path / f).read().splitlines() for f in ("one.csv", "grid.csv")]
    assert len(rows[0]) == len(rows[1]) > 1 and rows[0][0] == rows[1][0]  # the header
    for a, b in zip(rows[0][1:], rows[1][1:]):  # index, metrics..., target
        fa, fb = a.split(","), b.split(",")
        assert (fa[0], fa[-1]) == (fb[0], fb[-1])
        np.testing.assert_allclose([float(x) for x in fb[1:-1]], [float(x) for x in fa[1:-1]],
                                   atol=2e-6, rtol=0)
    assert not list((tmp_path / "grid").glob(".rendezvous-*"))
