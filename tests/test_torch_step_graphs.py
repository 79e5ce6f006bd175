"""The step graphs (training/step_graphs.py) on the card: a replay after
its state was restored from a checkpoint (a resume) and after its weights
were overwritten in place (SWA's average) computes on the new values,
equal to the eager body on the same values. This file imports no JAX: the
graphs are held against the port's own eager step; ``chip_smoke.py``
phase 13 holds them against eager ``cli.train`` runs at the flagship
width. Here on the CPU only the guard that refuses a CPU state runs."""


import numpy as np
import pytest
import torch

from deepinteract_tpu_torch.data.graph import stack_complexes
from deepinteract_tpu_torch.data.synthetic import random_complex
from deepinteract_tpu_torch.models.decoder import DecoderConfig
from deepinteract_tpu_torch.models.geometric_transformer import GTConfig
from deepinteract_tpu_torch.models.model import DeepInteract, ModelConfig
from deepinteract_tpu_torch.training.step_graphs import StepGraphs
from deepinteract_tpu_torch.training.steps import (create_train_state, multi_eval_step,
                                                   train_step)
from deepinteract_tpu_torch.weights import init_weights

torch.set_num_threads(1)
CFG = ModelConfig(gnn=GTConfig(hidden=16, num_heads=2, num_layers=1),
                  decoder=DecoderConfig(num_chunks=1, num_channels=16))


def _state(device, seed=5):
    model = DeepInteract(CFG)
    init_weights(model, seed)
    return create_train_state(model.to(device), seed=seed)


def _batches(n=3):
    rng = np.random.default_rng(17)
    return [stack_complexes([random_complex(26, 22, rng, n_pad1=32, n_pad2=32, knn=6)])
            for _ in range(n)]


def test_step_graphs_refuse_a_cpu_state():
    with pytest.raises(ValueError, match="CUDA"):
        StepGraphs(_state("cpu"))


def test_graph_capture_holds_the_collector_off_until_the_capture_ends(monkeypatch):
    """A cyclic collection inside a capture can destroy another CUDA graph
    in the capturing thread, which invalidates the capture: every capture
    of the port (step graphs, serving graphs) goes through
    ``device.graph_capture``, which keeps the collector off from before
    ``torch.cuda.graph`` begins until after it ends, and restores it on an
    error too."""
    import contextlib
    import gc

    from deepinteract_tpu_torch.device import graph_capture

    seen = []

    @contextlib.contextmanager
    def fake_graph(graph, pool=None, capture_error_mode="global"):
        seen.append(("begin", gc.isenabled(), pool, capture_error_mode))
        yield
        seen.append(("end", gc.isenabled()))

    monkeypatch.setattr(torch.cuda, "graph", fake_graph)
    assert gc.isenabled()
    with graph_capture("g", pool="p"):
        seen.append(("body", gc.isenabled()))
    assert gc.isenabled()
    assert seen == [("begin", False, "p", "thread_local"), ("body", False), ("end", False)]
    with pytest.raises(RuntimeError, match="capture failed"):
        with graph_capture("g"):
            raise RuntimeError("capture failed")
    assert gc.isenabled()


@pytest.mark.cuda
def test_replay_sees_weights_restored_or_averaged_after_its_capture():
    if not torch.cuda.is_available():
        pytest.skip("CUDA graphs need a card; chip_smoke.py phase 13 holds the step graphs "
                    "there")
    cuda = torch.device("cuda")
    batches = [b.to(cuda) for b in _batches()]
    graphed, eager = _state(cuda), _state(cuda)
    graphs = StepGraphs(graphed, guard=True)
    graphs.train(batches[0])
    train_step(eager, batches[0], guard=True)
    # A resume: another run's state loaded into the tensors the graph holds.
    other = _state(cuda, seed=6)
    train_step(other, batches[1], guard=True)
    snapshot = other.state_dict()
    graphed.load_state_dict(snapshot)
    eager.load_state_dict(snapshot)
    got = graphs.train(batches[2]).clone()
    want = torch.tensor(list(train_step(eager, batches[2], guard=True).values()), device=cuda)
    assert torch.equal(got, want)
    for a, b in zip(graphed.tensors(), eager.tensors()):
        assert torch.equal(a, b)
    # SWA: the parameters overwritten in place.
    with torch.no_grad():
        for s in (graphed, eager):
            for p in s.model.parameters():
                p.mul_(0.5)
    got = graphs.eval(batches[0])["logits"].clone()
    assert torch.equal(got, multi_eval_step(eager, batches[:1])["logits"][0])
