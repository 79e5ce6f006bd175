"""The GCN encoder and the DeepLab decoder capture as CUDA graphs: their
forwards read nothing on the host (ROADMAP.md F5, closed).

On the CPU: a GCN engine and a DeepLab engine of the port serve within
1e-4 of the JAX engine on carried weights; the GCN forward runs with every
host read of a tensor patched to raise, sums a hub of any in-degree whole
and is bitwise repeatable under deterministic algorithms; a second
``bilinear_resize`` at one shape builds no new interpolation matrix. On
the card, ``chip_smoke.py`` phase 9 captures a key of each configuration
and holds its replays against the eager forward.
"""

import dataclasses

import numpy as np
import pytest
import torch

from deepinteract_tpu.models.vision import DeepLabConfig as JaxDeepLabConfig
from deepinteract_tpu.serving import EngineConfig as JaxEngineConfig
from deepinteract_tpu.serving import InferenceEngine as JaxInferenceEngine
from deepinteract_tpu_torch import constants as C
from deepinteract_tpu_torch.data.synthetic import random_complex, random_raw_complex
from deepinteract_tpu_torch.models import vision
from deepinteract_tpu_torch.models.model import GCNStack
from deepinteract_tpu_torch.models.vision import DeepLabConfig
from deepinteract_tpu_torch.serving import EngineConfig, InferenceEngine
from torch_port_helpers import KNN, jax_cfg, port_cfg

SMALL_DEEPLAB = dict(stem_channels=4, stage_channels=(4, 8, 8, 8), stage_blocks=(1, 1, 1, 1),
                     aspp_rates=(2, 4, 6), decoder_channels=8, high_res_channels=4,
                     dropout_rate=0.0)
CASES = {
    "gcn": ({"gnn_layer_type": "gcn"}, {"gnn_layer_type": "gcn"}),
    "deeplab": ({"interact_module_type": "deeplab", "deeplab": JaxDeepLabConfig(**SMALL_DEEPLAB)},
                {"interact_module_type": "deeplab", "deeplab": DeepLabConfig(**SMALL_DEEPLAB)}),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def engines(request):
    jax_changes, port_changes = CASES[request.param]
    jeng = JaxInferenceEngine(dataclasses.replace(jax_cfg(), **jax_changes),
                              cfg=JaxEngineConfig(max_batch=2, result_cache_size=0))
    peng = InferenceEngine(dataclasses.replace(port_cfg(), **port_changes),
                           cfg=EngineConfig(max_batch=2, result_cache_size=0), device="cpu",
                           weights={"params": jeng.params, "batch_stats": jeng.batch_stats})
    yield jeng, peng
    jeng.close()
    peng.close()


@pytest.mark.parametrize("seed,n1,n2", [(10, 26, 22), (11, 40, 31)])
def test_engine_serves_the_configuration_like_the_jax_engine(engines, seed, n1, n2):
    jeng, peng = engines
    raw = random_raw_complex(n1, n2, np.random.default_rng(seed), knn=KNN)
    ref, got = jeng.predict(raw), peng.predict(raw)
    assert got["bucket"] == ref["bucket"] and got["probs"].shape == (n1, n2)
    np.testing.assert_allclose(got["probs"], ref["probs"], rtol=0, atol=1e-4)


def _gcn_and_graph(seed=0, n=20, pad=32):
    torch.manual_seed(seed)
    cfg = port_cfg().gnn
    gcn = GCNStack(cfg)
    for p in gcn.parameters():
        torch.nn.init.normal_(p, std=0.3)
    g = random_complex(n, n, np.random.default_rng(seed), n_pad1=pad, n_pad2=pad,
                       knn=KNN).graph1
    batch = type(g)(**{f.name: getattr(g, f.name)[None]
                       for f in dataclasses.fields(g)})
    feats = torch.randn(1, pad, cfg.hidden)
    return gcn, batch, feats


def test_gcn_forward_reads_nothing_on_the_host(monkeypatch):
    gcn, graph, feats = _gcn_and_graph()
    with torch.inference_mode():
        ref, _ = gcn(graph, feats)

    def host_read(*args, **kwargs):
        raise AssertionError("the GCN forward read a tensor on the host")

    for name in ("item", "__int__", "__bool__", "__float__", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    with torch.inference_mode():
        out, edges = gcn(graph, feats)
    monkeypatch.undo()
    assert edges is None and torch.equal(out, ref)


def _dense_gcn(gcn, graph, feats):
    """The GCN as dense numpy sums over every edge (float64)."""
    nbr = graph.nbr_idx[0].numpy()
    mask = graph.node_mask[0].numpy().astype(np.float64)
    w = graph.edge_feats[0, ..., C.EDGE_WEIGHT].numpy().astype(np.float64) * mask[:, None]
    n, k = nbr.shape
    deg_out = np.repeat(mask[:, None], k, 1).sum(1)
    deg_in = np.zeros(n)
    np.add.at(deg_in, nbr.reshape(-1), np.repeat(mask, k))
    ns, nd = 1 / np.sqrt(np.maximum(deg_out, 1e-9)), 1 / np.sqrt(np.maximum(deg_in, 1e-9))
    h = feats[0].double().numpy()
    for i in range(gcn.cfg.num_layers):
        with torch.no_grad():
            hn = getattr(gcn, f"gcn_{i}")(torch.from_numpy(h).float()).double().numpy()
        hn = hn * ns[:, None]
        agg = np.zeros_like(hn)
        np.add.at(agg, nbr.reshape(-1), np.repeat(hn, k, 0) * w.reshape(-1, 1))
        h = (agg * nd[:, None] + getattr(gcn, f"gcn_bias_{i}").detach().double().numpy()) \
            * mask[:, None]
    return h


def test_gcn_sums_a_hub_of_any_in_degree_whole():
    """Every real node's edges point at node 0 except one slot each: node
    0's in-degree is over 100 (the padded nodes' self-loops add theirs),
    and its sum matches dense float64 sums within 1e-5."""
    gcn, graph, feats = _gcn_and_graph(n=26, pad=32)
    nbr = graph.nbr_idx.clone()
    nbr[0, :26, 1:] = 0
    hub = dataclasses.replace(graph, nbr_idx=nbr)
    assert int((nbr == 0).sum()) > 100
    with torch.inference_mode():
        out, _ = gcn(hub, feats)
    np.testing.assert_allclose(out[0].double().numpy(), _dense_gcn(gcn, hub, feats),
                               rtol=0, atol=1e-5)


def test_gcn_is_bitwise_repeatable_under_deterministic_algorithms():
    gcn, graph, feats = _gcn_and_graph(seed=1)
    torch.use_deterministic_algorithms(True)
    try:
        with torch.inference_mode():
            a, _ = gcn(graph, feats)
            b, _ = gcn(graph, feats)
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(a, b)


def test_a_second_bilinear_resize_at_one_shape_builds_no_matrix(monkeypatch):
    calls = []
    real = vision.resize_matrix

    def counting(in_size, out_size):
        calls.append((in_size, out_size))
        return real(in_size, out_size)

    monkeypatch.setattr(vision, "resize_matrix", counting)
    x = torch.randn(2, 3, 5, 7, dtype=torch.float64)  # a dtype no other test resizes
    first = vision.bilinear_resize(x, (13, 11))
    assert sorted(calls) == [(5, 13), (7, 11)]
    second = vision.bilinear_resize(x, (13, 11))
    assert len(calls) == 2 and torch.equal(first, second)
    # Kept outside inference mode: usable in a backward after an
    # inference-mode forward made it.
    with torch.inference_mode():
        vision.bilinear_resize(torch.randn(1, 1, 3, 3, dtype=torch.float64), (6, 9))
    y = torch.randn(1, 1, 3, 3, dtype=torch.float64, requires_grad=True)
    vision.bilinear_resize(y, (6, 9)).sum().backward()
    assert y.grad is not None and len(calls) == 4
