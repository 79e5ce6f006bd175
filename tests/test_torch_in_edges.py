"""The in-edge CSR (``ops/cuda_attention.in_edge_csr``) and the dataflow of
the kernels that walk it.

K1 and K2 run only on the card (``chip_smoke.py`` holds them against their
plain versions there). Here, on the CPU:
  * the CSR against a numpy stable argsort, on kNN graphs with padded
    tails, an orphan node and a hub that takes every real edge;
  * a plain-torch model of the kernels' dataflow (K1 walking each
    destination's in-edges; K2's pass A writing the per-(edge, head) scalar
    dsum and pass B recomputing da per in-edge from dsum, pe, de, k[src] and
    q[dst]) against the TPU kernels ``_pallas_forward`` / ``_pallas_backward``
    run by the Pallas interpreter;
  * that the GT encoder builds the CSR once per forward on the kernel route
    and that K1 and K2 receive that same CSR (``_on_cuda`` and ``_launch``
    stubbed, as in test_torch_attention.py).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinteract_tpu.data import features as F
from deepinteract_tpu.data.synthetic import random_backbone
from deepinteract_tpu.ops.pallas_attention import _pallas_backward, _pallas_forward
from deepinteract_tpu_torch.models.geometric_transformer import GeometricTransformer, GTConfig
from deepinteract_tpu_torch.ops import cuda_attention
from deepinteract_tpu_torch.ops.cuda_attention import (EdgeAttention, attention_graph,
                                                       in_edge_csr)
from torch_port_helpers import HEADS, HIDDEN, LIMIT, PAD, complexes

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
CLIP, EPS = 5.0, 1e-6


def _graphs(kind, seed=0, b=2, n=32, n_real=27, k=6):
    """nbr [B, N, K] int32 of kNN graphs over n_real residues with a
    self-pointing padded tail, and the edge mask. ``orphan``: node 7 of
    every graph loses its in-edges to node 8; ``hub``: every real edge goes
    to node 3."""
    rng = np.random.default_rng(seed)
    nbr = np.empty((b, n, k), np.int32)
    for g in range(b):
        nbr[g, :n_real] = F.knn_edges(random_backbone(n_real, rng)[:, 1, :], k)[0]
        nbr[g, n_real:] = np.arange(n_real, n)[:, None]
    if kind == "orphan":
        nbr[nbr == 7] = 8
    elif kind == "hub":
        nbr[:, :n_real] = 3
    mask = np.zeros((b, n, k), bool)
    mask[:, :n_real] = True
    return nbr, mask


def _reference_csr(nbr):
    b, n, k = nbr.shape
    flat = nbr.reshape(b, n * k)
    order = np.argsort(flat, axis=1, kind="stable")
    counts = np.stack([np.bincount(row, minlength=n) for row in flat])
    return np.concatenate([np.zeros((b, 1), np.int64), np.cumsum(counts, 1)], 1), order


@pytest.mark.parametrize("kind", ["knn", "orphan", "hub"])
def test_in_edge_csr_matches_stable_argsort(kind):
    nbr, _ = _graphs(kind)
    b, n, k = nbr.shape
    in_ptr, in_eid = in_edge_csr(torch.from_numpy(nbr))
    assert in_ptr.dtype == torch.int32 and in_ptr.shape == (b, n + 1)
    assert in_eid.dtype == torch.int32 and in_eid.shape == (b, n * k)
    ptr, eid = in_ptr.numpy(), in_eid.numpy()
    ref_ptr, ref_eid = _reference_csr(nbr)
    np.testing.assert_array_equal(ptr, ref_ptr)
    np.testing.assert_array_equal(eid, ref_eid)
    assert (ptr[:, 0] == 0).all() and (np.diff(ptr, axis=1) >= 0).all()
    assert (ptr[:, -1] == n * k).all()
    flat = nbr.reshape(b, n * k)
    for g in range(b):
        np.testing.assert_array_equal(np.sort(eid[g]), np.arange(n * k))  # each edge once
        for node in range(n):
            ids = eid[g, ptr[g, node]:ptr[g, node + 1]]
            assert (np.diff(ids) > 0).all()  # ascending edge id
            assert (flat[g, ids] == node).all()
    if kind == "orphan":
        assert (ptr[:, 8] == ptr[:, 7]).all()
    if kind == "hub":
        assert (np.diff(ptr, axis=1)[:, 3] >= 27 * k).all()
    again = in_edge_csr(torch.from_numpy(nbr).long())
    assert torch.equal(again[0], in_ptr) and torch.equal(again[1], in_eid)


@pytest.mark.parametrize("n", [32766, 32767])
def test_in_edge_csr_key_width(n):
    """16-bit sort keys up to N = 32766 (N + 1 node bounds fit), 32-bit
    from N = 32767 on: the same CSR either way."""
    nbr = np.random.default_rng(n).integers(0, n, size=(1, n, 2)).astype(np.int32)
    in_ptr, in_eid = in_edge_csr(torch.from_numpy(nbr))
    ref_ptr, ref_eid = _reference_csr(nbr)
    np.testing.assert_array_equal(in_ptr.numpy(), ref_ptr)
    np.testing.assert_array_equal(in_eid.numpy(), ref_eid)


# ---------------------------------------------------------------------------
# The kernels' dataflow as plain torch
# ---------------------------------------------------------------------------


def _walk(in_ptr, in_eid):
    """(graph, destination, its in-edge ids) in the kernels' order."""
    for g in range(in_ptr.shape[0]):
        for node in range(in_ptr.shape[1] - 1):
            yield g, node, in_eid[g, in_ptr[g, node]:in_ptr[g, node + 1]].long()


def k1_model(q, k, v, pe, nbr, mask):
    """K1: per destination, over its in-edges from the CSR, the scores from
    k[src], q[dst] and pe[e]; e_out[e] written once per edge; w*v and w
    summed into the destination."""
    b, n, h, d = q.shape
    kk = nbr.shape[-1]
    in_ptr, in_eid = in_edge_csr(nbr)
    pe_e, m_e = pe.reshape(b, n * kk, h, d), mask.reshape(b, n * kk).float()
    h_out = torch.zeros(b, n, h, d)
    z_out = torch.zeros(b, n, h)
    e_out = torch.full((b, n * kk, h, d), float("nan"))
    for g, dst, ids in _walk(in_ptr, in_eid):
        src = ids // kk
        s = torch.clamp(k[g, src] * q[g, dst] / math.sqrt(d), -CLIP, CLIP) * pe_e[g, ids]
        m = m_e[g, ids][:, None]
        assert torch.isnan(e_out[g, ids]).all()  # nothing written twice
        e_out[g, ids] = s * m[..., None]
        w = torch.exp(torch.clamp(s.sum(-1), -CLIP, CLIP)) * m        # [deg, H]
        z_out[g, dst] = w.sum(0)
        h_out[g, dst] = (w[..., None] * v[g, src]).sum(0) / (z_out[g, dst][:, None] + EPS)
    z_wide = z_out[..., None].expand(b, n, h, d).reshape(b, n, h * d)
    return h_out, e_out.reshape(b, n, kk, h, d), z_wide


def k2_model(q, k, v, pe, nbr, mask, h_res, z_res, dh, de):
    """K2: pass A per source over its K out-edges (dpe, dk, dv and the
    per-(edge, head) scalar dsum, no H*D-wide dq share); pass B per
    destination over the CSR, recomputing a and da from dsum, pe, de,
    k[src] and q[dst]."""
    b, n, h, d = q.shape
    kk = nbr.shape[-1]
    inv = 1.0 / math.sqrt(d)
    nb = nbr.long()
    gather = lambda x: x[torch.arange(b)[:, None, None], nb]  # noqa: E731
    m = mask.float()[..., None]                                      # [B,N,K,1]
    q_dst, k_src, v_src = gather(q), k[:, :, None], v[:, :, None]
    a = k_src * q_dst * inv
    c = torch.clamp(a, -CLIP, CLIP)
    sum_pre = (c * pe).sum(-1)
    w = torch.exp(torch.clamp(sum_pre, -CLIP, CLIP)) * m
    dnum = dh * (1.0 / (z_res.reshape(b, n, h, d) + EPS))
    dw = (gather(dnum) * v_src).sum(-1) - gather((h_res * dnum).sum(-1))
    dsum = torch.where((sum_pre > -CLIP) & (sum_pre < CLIP), dw * w, 0.0)   # [B,N,K,H]
    ds = dsum[..., None] + (0.0 if de is None else de * m[..., None])
    dpe = ds * c
    da = torch.where((a > -CLIP) & (a < CLIP), ds * pe, 0.0) * inv
    dk = (da * q_dst).sum(2)
    dv = (w[..., None] * gather(dnum)).sum(2)

    in_ptr, in_eid = in_edge_csr(nbr)
    dsum_e, pe_e = dsum.reshape(b, n * kk, h), pe.reshape(b, n * kk, h, d)
    de_e = None if de is None else (de * m[..., None]).reshape(b, n * kk, h, d)
    dq = torch.zeros(b, n, h, d)
    for g, dst, ids in _walk(in_ptr, in_eid):
        src = ids // kk
        a_e = k[g, src] * q[g, dst] * inv
        ds_e = dsum_e[g, ids][..., None] + (0.0 if de_e is None else de_e[g, ids])
        da_e = torch.where((a_e > -CLIP) & (a_e < CLIP), ds_e * pe_e[g, ids], 0.0) * inv
        dq[g, dst] = (da_e * k[g, src]).sum(0)
    return dq, dk, dv, dpe


def _dataflow_inputs(kind, seed):
    nbr, mask = _graphs(kind, seed=seed)
    rng = np.random.default_rng(seed + 100)
    b, n, kk = nbr.shape
    q, k, v = (rng.standard_normal((b, n, 2, 8)).astype(np.float32) for _ in range(3))
    pe = rng.standard_normal((b, n, kk, 2, 8)).astype(np.float32)
    return q, k, v, pe, nbr, mask


@pytest.mark.parametrize("kind", ["knn", "orphan"])
def test_k1_dataflow_matches_pallas_interpret(kind):
    arrays = _dataflow_inputs(kind, seed=1)
    jh, je, jz = _pallas_forward(*(jnp.asarray(a) for a in arrays), interpret=True)
    ours = k1_model(*(torch.from_numpy(a) for a in arrays))
    for got, ref in zip(ours, (jh, je, jz)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)
    if kind == "orphan":
        assert torch.all(ours[0][:, 7] == 0) and torch.all(ours[2][:, 7] == 0)


@pytest.mark.parametrize("with_de", [True, False], ids=["de", "de_none"])
@pytest.mark.parametrize("kind", ["knn", "orphan"])
def test_k2_dataflow_matches_pallas_interpret(kind, with_de):
    arrays = _dataflow_inputs(kind, seed=2)
    q, k, v, pe, nbr, mask = arrays
    rng = np.random.default_rng(7)
    dh = rng.standard_normal(q.shape).astype(np.float32)
    de = (rng.standard_normal(pe.shape) if with_de else np.zeros(pe.shape)).astype(np.float32)
    jarr = [jnp.asarray(a) for a in arrays]
    jh, _, jz = _pallas_forward(*jarr, interpret=True)
    ref = _pallas_backward(*jarr, jh, jz, jnp.asarray(dh), jnp.asarray(de), interpret=True)
    ours = k2_model(*(torch.from_numpy(a) for a in arrays), torch.from_numpy(np.array(jh)),
                    torch.from_numpy(np.array(jz)), torch.from_numpy(dh),
                    torch.from_numpy(de) if with_de else None)
    for name, got, r in zip(("dq", "dk", "dv", "dpe"), ours, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), err_msg=name, **GRAD_TOL)
    assert torch.all(ours[3][~torch.from_numpy(mask)] == 0)
    if kind == "orphan":
        assert torch.all(ours[0][:, 7] == 0)


# ---------------------------------------------------------------------------
# One build per encode, shared by K1 and K2
# ---------------------------------------------------------------------------


@pytest.fixture
def stub_card(monkeypatch):
    """Route the wrappers as if the tensors lay on a card and record each
    launch's arguments instead of running it; zero the counters."""
    launched = []
    monkeypatch.setattr(cuda_attention, "_on_cuda", lambda t: True)
    monkeypatch.setattr(cuda_attention, "_launch",
                        lambda name, device, *args: launched.append((name, args)))
    for kernel in (cuda_attention.edge_attention_forward, cuda_attention.edge_attention_backward):
        monkeypatch.setattr(kernel, "launches", 0)
    monkeypatch.setattr(in_edge_csr, "builds", 0)
    return launched


def _csr_pointers(launched):
    """(in_ptr, in_eid) data pointers each launch was given."""
    slots = {"edge_attention_fwd": (4, 5), "edge_attention_bwd": (6, 7)}
    return [tuple(args[i] for i in slots[name]) for name, args in launched]


def test_gt_builds_csr_once_per_forward_and_shares_it(stub_card):
    _, cx = complexes()
    gt = GeometricTransformer(GTConfig(hidden=HIDDEN, num_heads=HEADS, node_count_limit=LIMIT,
                                       attention_impl="kernel")).eval()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, PAD, HIDDEN))
                         .astype(np.float32))
    nodes, edges = gt(cx.graph1, x)
    assert in_edge_csr.builds == 1
    assert [name for name, _ in stub_card] == ["edge_attention_fwd"] * 2
    (nodes.sum() + edges.sum()).backward()
    assert in_edge_csr.builds == 1
    assert [name for name, _ in stub_card] == ["edge_attention_fwd"] * 2 + ["edge_attention_bwd"] * 2
    assert len(set(_csr_pointers(stub_card))) == 1  # one CSR for all four launches
    assert cuda_attention.edge_attention_backward.launches == 2

    with torch.no_grad():
        gt(cx.graph1, x)
    assert in_edge_csr.builds == 2
    assert cuda_attention.edge_attention_forward.launches == 4
    assert cuda_attention.edge_attention_backward.launches == 2
    assert len(set(_csr_pointers(stub_card[4:]))) == 1


def test_edge_attention_function_builds_once_without_a_csr(stub_card):
    """Called without a CSR, EdgeAttention builds one in the forward and
    hands that one to K2; the bare wrappers build their own per call."""
    q, k, v, pe, nbr, mask = (torch.from_numpy(a) for a in _dataflow_inputs("knn", seed=3))
    nbr, mask = nbr.int(), mask.float()
    leaves = [t.requires_grad_(True) for t in (q, k, v, pe)]
    h, _ = EdgeAttention.apply(*leaves, nbr, mask)
    h.sum().backward()
    assert in_edge_csr.builds == 1
    assert len(set(_csr_pointers(stub_card))) == 1 and len(stub_card) == 2
    with torch.no_grad():
        cuda_attention.edge_attention_forward(q, k, v, pe, nbr, mask)
        cuda_attention.edge_attention_forward(q, k, v, pe, nbr, mask,
                                              in_edges=in_edge_csr(nbr))
    assert in_edge_csr.builds == 3


def test_attention_graph_builds_only_where_kernels_run(monkeypatch):
    """On CPU tensors the wrappers run the plain versions, so neither
    attention_graph nor the GT encoder (any route) builds a CSR."""
    monkeypatch.setattr(in_edge_csr, "builds", 0)
    nbr, mask = _graphs("knn")
    prepared = attention_graph(torch.from_numpy(nbr).long(), torch.from_numpy(mask))
    assert prepared.in_edges is None
    assert prepared.nbr_idx.dtype == torch.int32 and prepared.edge_mask.dtype == torch.float32
    _, cx = complexes()
    x = torch.zeros(1, PAD, HIDDEN)
    for impl in ("auto", "kernel", "plain"):
        gt = GeometricTransformer(GTConfig(hidden=HIDDEN, num_heads=HEADS,
                                           node_count_limit=LIMIT, attention_impl=impl))
        with torch.no_grad():
            gt.eval()(cx.graph1, x)
    assert in_edge_csr.builds == 0


@pytest.mark.parametrize("bad", ["dtype", "shape"])
def test_wrapper_checks_a_given_csr(stub_card, bad):
    q, k, v, pe, nbr, mask = (torch.from_numpy(a) for a in _dataflow_inputs("knn", seed=4))
    nbr, mask = nbr.int(), mask.float()
    in_ptr, in_eid = in_edge_csr(nbr)
    if bad == "dtype":
        in_eid = in_eid.long()
    else:
        in_ptr = in_ptr[:, :-1].contiguous()
    with pytest.raises(ValueError, match="in_"):
        cuda_attention.edge_attention_forward(q, k, v, pe, nbr, mask, in_edges=(in_ptr, in_eid))
    assert stub_card == []
