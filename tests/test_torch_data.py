"""The port's data layer (constants, data/graph.py, data/io.py,
data/features.py, data/synthetic.py) against the JAX package's: the same
seed gives the same complex, and npz files cross between the packages
unchanged."""

import dataclasses

import numpy as np
import pytest
import torch

from deepinteract_tpu import constants as jax_constants
from deepinteract_tpu.data import io as jax_io
from deepinteract_tpu.data.graph import pick_bucket as jax_pick_bucket
from deepinteract_tpu.data.synthetic import random_complex as jax_random_complex
from deepinteract_tpu.data.synthetic import random_raw_complex as jax_random_raw_complex
from deepinteract_tpu_torch import constants
from deepinteract_tpu_torch.data import io
from deepinteract_tpu_torch.data.graph import ProteinGraph, pad_graph, pick_bucket
from deepinteract_tpu_torch.data.synthetic import random_complex, random_raw_complex
from test_golden_parity import _load_fixture


def _assert_graph_equal(port_graph, jax_graph):
    for field in dataclasses.fields(ProteinGraph):
        ours = getattr(port_graph, field.name)
        ref = np.asarray(getattr(jax_graph, field.name))
        np.testing.assert_array_equal(ours.numpy(), ref, err_msg=field.name)


def test_constants_are_a_copy():
    public = {k: v for k, v in vars(jax_constants).items() if k.isupper()}
    assert public == {k: v for k, v in vars(constants).items() if k.isupper()}


def test_random_complex_matches_jax_seed_for_seed():
    ours = random_complex(40, 30, np.random.default_rng(11), knn=8)
    ref = jax_random_complex(40, 30, np.random.default_rng(11), knn=8)
    _assert_graph_equal(ours.graph1, ref.graph1)
    _assert_graph_equal(ours.graph2, ref.graph2)
    for name in ("examples", "example_mask", "contact_map"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_npz_crosses_between_packages(tmp_path, direction):
    path = str(tmp_path / "c.npz")
    if direction == "jax_to_port":
        raw = jax_random_raw_complex(30, 25, np.random.default_rng(12), knn=6)
        jax_io.save_complex_npz(path, raw["graph1"], raw["graph2"], raw["examples"], "x")
        loaded, ref = io.load_complex_npz(path), jax_io.load_complex_npz(path)
    else:
        raw = random_raw_complex(30, 25, np.random.default_rng(12), knn=6)
        io.save_complex_npz(path, raw["graph1"], raw["graph2"], raw["examples"], "x")
        loaded, ref = jax_io.load_complex_npz(path), io.load_complex_npz(path)
    assert loaded["complex_name"] == ref["complex_name"] == "x"
    ours = io.to_paired_complex(io.load_complex_npz(path), input_indep=True)
    theirs = jax_io.to_paired_complex(jax_io.load_complex_npz(path), input_indep=True)
    _assert_graph_equal(ours.graph1, theirs.graph1)
    _assert_graph_equal(ours.graph2, theirs.graph2)
    np.testing.assert_array_equal(ours.contact_map.numpy(), np.asarray(theirs.contact_map))


def test_pad_graph_points_padded_nodes_at_themselves():
    raw = random_raw_complex(21, 21, np.random.default_rng(13), knn=6)["graph1"]
    g = pad_graph(raw, 32)
    assert torch.equal(g.nbr_idx[21:], torch.arange(21, 32)[:, None].expand(11, 6))
    assert not g.edge_mask()[21:].any() and g.edge_mask()[:21].all()
    assert int(g.src_nbr_eids[21:].max()) < 32 * 6
    assert all(pick_bucket(n) == jax_pick_bucket(n) for n in (1, 64, 65, 200, 256, 257, 700))


def test_golden_fixture_inputs_round_trip_into_port_containers():
    _, cx, _, _ = _load_fixture()
    g = ProteinGraph(**{f.name: torch.from_numpy(np.asarray(getattr(cx.graph1, f.name)))
                        for f in dataclasses.fields(ProteinGraph)})
    _assert_graph_equal(g.to("cpu"), cx.graph1)
    assert g.edge_mask().shape == tuple(cx.graph1.nbr_idx.shape)
