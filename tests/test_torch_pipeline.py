"""The port's featurization front end (``deepinteract_tpu_torch.pipeline``,
``data/convert.py``) against the JAX package's on the same PDB files.

The files are written here (``torch_port_helpers``): the poly-alanine helix
of ``tests/test_pipeline.py``, helices cycling through the 20 standard
residues with side-chain atoms, a bound two-chain complex, and the
parser's edge cases. Arrays are held equal exactly: both packages run the
same numpy code and the same C++ source built with the same flags. The
native and numpy paths of the port are held to each other at the JAX
package's bar (rtol 1e-4, atol 1e-3, ``tests/test_pipeline.py``)."""

import logging
import pickle
import stat
import subprocess
import zipfile

import numpy as np
import pytest

from deepinteract_tpu.data import convert as jax_convert
from deepinteract_tpu.pipeline import native as jax_native
from deepinteract_tpu.pipeline import pair as jax_pair
from deepinteract_tpu.pipeline import pdb as jax_pdb
from deepinteract_tpu.pipeline import postprocess as jax_post
from deepinteract_tpu.pipeline import residue_features as jax_rf
from deepinteract_tpu.robustness import faults as jax_faults
from deepinteract_tpu_torch.data import convert
from deepinteract_tpu_torch.pipeline import native, pair, pdb, postprocess
from deepinteract_tpu_torch.pipeline import residue_features as rf
from deepinteract_tpu_torch.robustness import faults
from test_hhblits import write_fixture
from torch_port_helpers import write_bound_pdb, write_helix_pdb, write_mixed_pdb

NATIVE_BAR = dict(rtol=1e-4, atol=1e-3)  # tests/test_pipeline.py TestNativeParity

EDGE_CASES = {
    # Hydrogen and water dropped.
    "mixed": "ATOM      1  N   GLY A   1       0.000   0.000   0.000  1.00  0.00           N\n"
             "ATOM      2  CA  GLY A   1       1.450   0.000   0.000  1.00  0.00           C\n"
             "ATOM      3  H   GLY A   1       0.500   0.900   0.000  1.00  0.00           H\n"
             "HETATM    4  O   HOH A 101       5.000   5.000   5.000  1.00  0.00           O\n",
    # No element columns ('1HB' is a hydrogen); an altloc-B-only residue.
    "legacy": "ATOM      1  N   ALA A   1       0.000   0.000   0.000\n"
              "ATOM      2  CA  ALA A   1       1.450   0.000   0.000\n"
              "ATOM      3 1HB  ALA A   1       2.000   1.000   0.000\n"
              "ATOM      4  CA BALA A   2       4.800   0.000   0.000  1.00  0.00           C\n",
    # A residue without CA is skipped; a second model is ignored.
    "noca": "MODEL        1\n"
            "ATOM      1  N   GLY A   1       0.000   0.000   0.000  1.00  0.00           N\n"
            "ATOM      2  CA  ALA A   2       3.800   0.000   0.000  1.00  0.00           C\n"
            "ENDMDL\nMODEL        2\n"
            "ATOM      3  CA  ALA A   3       9.800   0.000   0.000  1.00  0.00           C\n"
            "ENDMDL\n",
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("pdb")
    out = {"helix": write_helix_pdb(str(d / "helix.pdb")),
           "left": write_mixed_pdb(str(d / "l.pdb"), 30),
           "right": write_mixed_pdb(str(d / "r.pdb"), 26, chain="B", x0=11.0, first=7),
           "bound": write_bound_pdb(str(d / "bound.pdb"), 24, 22)}
    for name, text in EDGE_CASES.items():
        (d / f"{name}.pdb").write_text(text)
        out[name] = str(d / f"{name}.pdb")
    return out


def chain_pairs(files, name):
    """(JAX chain, port chain) pairs of every chain of a file."""
    j, p = jax_pdb.parse_pdb_chains(files[name]), pdb.parse_pdb_chains(files[name])
    assert sorted(j) == sorted(p)
    return [(j[c], p[c]) for c in sorted(j)]


def assert_chain_equal(jc, pc):
    for field in ("chain_id", "resnames", "res_ids", "atom_names", "elements"):
        assert getattr(jc, field) == getattr(pc, field), field
    for field in ("atom_start", "coords"):
        np.testing.assert_array_equal(getattr(pc, field), getattr(jc, field), err_msg=field)
    np.testing.assert_array_equal(pc.backbone(), jc.backbone())
    np.testing.assert_array_equal(pc.cb_coords(), jc.cb_coords())
    for a, b in zip(pc.side_chain_slices(), jc.side_chain_slices()):
        np.testing.assert_array_equal(a, b)
    assert pc.sequence() == jc.sequence()


@pytest.mark.parametrize("name", ["helix", "left", "bound", "mixed", "legacy", "noca"])
def test_parser_matches_jax(files, name):
    pairs = chain_pairs(files, name)
    assert pairs
    for jc, pc in pairs:
        assert_chain_equal(jc, pc)


def test_merge_slice_and_writer_match_jax(files, tmp_path):
    (ja, pa), (jb, pb) = chain_pairs(files, "bound")
    jm, pm = jax_pdb.merge_chains([ja, jb]), pdb.merge_chains([pa, pb])
    assert_chain_equal(jm, pm)
    assert_chain_equal(jax_pdb.Chain.slice_residues(ja, 3, 11), pa.slice_residues(3, 11))
    jax_pdb.write_pdb(ja, str(tmp_path / "j.pdb"))
    pdb.write_pdb(pa, str(tmp_path / "p.pdb"))
    assert (tmp_path / "j.pdb").read_text() == (tmp_path / "p.pdb").read_text()
    # The written file parses back to the chain (gzip too).
    import gzip

    with gzip.open(tmp_path / "p.pdb.gz", "wt") as f:
        f.write((tmp_path / "p.pdb").read_text())
    assert_chain_equal(ja, pdb.parse_pdb_chains(str(tmp_path / "p.pdb.gz"))["A"])


def residue_features(mod_rf, mod_post, chain, use_native):
    """Every residue feature of one chain through one package."""
    sasa, depth = mod_rf.sasa_and_depth(chain.coords, mod_rf.atom_radii(chain.elements),
                                        use_native=use_native)
    md = mod_rf.min_dist_matrix(chain, use_native=use_native)
    close, cn = mod_rf.similarity_matrix(md)
    ss = mod_rf.assign_secondary_structure(chain.backbone(), chain.resnames)
    zeros = np.zeros((len(chain), 27), np.float32)
    return {
        "sasa": sasa, "depth": depth, "min_dist": md, "close": close, "cn": cn,
        "rsa": mod_rf.relative_solvent_accessibility(chain, sasa),
        "residue_depth": mod_rf.residue_depth(chain, depth),
        "protrusion": mod_rf.protrusion_stats(chain, use_native=use_native),
        "side_chain_vectors": mod_rf.side_chain_vectors(chain),
        "hsaac": mod_rf.hsaac(chain, close),
        "ss": np.asarray(ss), "ss_one_hot": mod_rf.ss_one_hot(ss),
        "resname_one_hot": mod_rf.resname_one_hot(chain.resnames),
        "residue_feats": mod_post.compute_residue_features(chain, use_native=use_native,
                                                           sequence_feats=zeros),
        "amide_normals": mod_post.amide_normal_vectors_for_chain(chain),
    }


@pytest.mark.parametrize("path", ["numpy", "native"])
@pytest.mark.parametrize("name", ["helix", "left", "bound"])
def test_residue_features_match_jax(files, name, path):
    use_native = path == "native"
    for jc, pc in chain_pairs(files, name):
        want = residue_features(jax_rf, jax_post, jc, use_native)
        got = residue_features(rf, postprocess, pc, use_native)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_disable_native_selects_the_numpy_path(files, monkeypatch):
    (_, chain), = chain_pairs(files, "left")
    want = rf.sasa_and_depth(chain.coords, rf.atom_radii(chain.elements), use_native=False)
    monkeypatch.setenv("DI_DISABLE_NATIVE", "1")
    assert not native.available() and native.disabled_reason() == "DI_DISABLE_NATIVE is set"
    got = rf.sasa_and_depth(chain.coords, rf.atom_radii(chain.elements))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(RuntimeError, match="requested but unavailable"):
        rf.protrusion_stats(chain, use_native=True)


@pytest.mark.parametrize("name", ["left", "bound"])
def test_native_matches_numpy_at_the_jax_bar(files, name):
    assert native.available(), native.disabled_reason()
    assert native.library_path().parent == native.BUILD_DIR
    for _, ch in chain_pairs(files, name):
        radii = rf.atom_radii(ch.elements)
        for got, want in zip(native.sasa_and_depth(ch.coords, radii, rf.N_SPHERE,
                                                   rf.PROBE_RADIUS),
                             rf._sasa_and_depth_numpy(ch.coords, radii)):
            np.testing.assert_allclose(got, want, **NATIVE_BAR)
        np.testing.assert_allclose(native.min_dist_matrix(ch.coords, ch.atom_start),
                                   rf._min_dist_matrix_numpy(ch.coords, ch.atom_start),
                                   **NATIVE_BAR)
        np.testing.assert_allclose(
            native.protrusion_cx(ch.coords, rf.CX_SPHERE_RADIUS, rf.CX_ATOM_VOLUME),
            rf._protrusion_cx_numpy(ch.coords), **NATIVE_BAR)
    (_, a), (_, b) = chain_pairs(files, "bound")
    np.testing.assert_array_equal(pair.interface_labels(a, b, use_native=True),
                                  pair.interface_labels(a, b, use_native=False))
    with pytest.raises(ValueError, match="residue offsets"):
        native.min_dist_matrix(a.coords, a.atom_start[:-1])


def npz_arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def assert_npz_equal(got, want):
    a, b = npz_arrays(got), npz_arrays(want)
    assert sorted(a) == sorted(b)
    for key in b:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("with_labels", [True, False])
@pytest.mark.parametrize("path", ["numpy", "native"])
def test_convert_pdb_pair_matches_jax(files, tmp_path, monkeypatch, path, with_labels):
    if path == "numpy":  # both packages pick their numpy path on their own
        monkeypatch.setenv("DI_DISABLE_NATIVE", "1")
    kw = dict(with_labels=with_labels, use_native=None, seed=5)
    want = jax_pair.convert_pdb_pair_to_complex(files["left"], files["right"],
                                                output_npz=str(tmp_path / "j.npz"), **kw)
    got = pair.convert_pdb_pair_to_complex(files["left"], files["right"],
                                           output_npz=str(tmp_path / "p.npz"), **kw)
    assert_npz_equal(tmp_path / "p.npz", tmp_path / "j.npz")
    assert got["complex_name"] == want["complex_name"]
    assert (got["examples"][:, 2].sum() > 0) == with_labels


def test_convert_bound_complex_matches_jax(files, tmp_path):
    kw = dict(knn=8, geo_nbrhd_size=3, seed=11)
    want = jax_pair.convert_bound_complex_to_pair(files["bound"], "A", "B",
                                                  output_npz=str(tmp_path / "j.npz"), **kw)
    got = pair.convert_bound_complex_to_pair(files["bound"], "A", "B",
                                             output_npz=str(tmp_path / "p.npz"), **kw)
    assert_npz_equal(tmp_path / "p.npz", tmp_path / "j.npz")
    assert got["examples"][:, 2].sum() == want["examples"][:, 2].sum() > 0
    # A merged multi-chain file through load_structure, and the errors.
    np.testing.assert_array_equal(pair.load_structure(files["bound"]).coords,
                                  jax_pair.load_structure(files["bound"]).coords)
    for mod in (jax_pair, pair):
        with pytest.raises(ValueError, match="chain 'C' not found"):
            mod.convert_bound_complex_to_pair(files["bound"], "C", "B")
        with pytest.raises(ValueError, match="no parseable protein chains"):
            mod.load_structure(files["bound"], chain_id="Z")


# ---------------------------------------------------------------------------
# Sequence profiles


def test_zero_profile_and_warning_without_hhblits(monkeypatch, caplog):
    monkeypatch.delenv("DI_HHBLITS_BIN", raising=False)
    monkeypatch.delenv("DI_HHBLITS_DB", raising=False)
    messages = []
    for mod in (jax_post, postprocess):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            out = mod.sequence_profile("ACDEFG")
        assert out.shape == (6, 27) and out.dtype == np.float32 and not out.any()
        messages.append([r.getMessage() for r in caplog.records])
    assert messages[0] == messages[1] and "set to zeros" in messages[1][0]


@pytest.fixture()
def fake_hhblits(tmp_path):
    """An executable that writes the canned ``.hhm`` of
    ``tests/test_hhblits.py`` to its ``-ohhm`` argument."""
    canned = tmp_path / "canned.hhm"
    write_fixture(str(canned))
    script = tmp_path / "hhblits"
    script.write_text("#!/bin/sh\nout=\"\"\nwhile [ $# -gt 0 ]; do\n"
                      "  if [ \"$1\" = \"-ohhm\" ]; then out=\"$2\"; shift; fi\n  shift\ndone\n"
                      f"cp \"{canned}\" \"$out\"\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script)


def test_fake_hhblits_profile_matches_jax(fake_hhblits, files, monkeypatch, tmp_path):
    monkeypatch.setenv("DI_HHBLITS_BIN", fake_hhblits)
    monkeypatch.setenv("DI_HHBLITS_DB", "/nonexistent/db")
    want, got = jax_post.sequence_profile("ACDE"), postprocess.sequence_profile("ACDE")
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 1.0 and not got[3].any()  # 3 records for 4 residues
    write_fixture(str(tmp_path / "q.hhm"))
    np.testing.assert_array_equal(postprocess.parse_hhm(str(tmp_path / "q.hhm"), 3),
                                  jax_post.parse_hhm(str(tmp_path / "q.hhm"), 3))
    # The profile reaches the node features of a featurized chain.
    (jc, pc), = chain_pairs(files, "helix")
    np.testing.assert_array_equal(postprocess.compute_residue_features(pc),
                                  jax_post.compute_residue_features(jc))


# ---------------------------------------------------------------------------
# Fault sites: native.compile and hhblits.run, as in the JAX package


@pytest.fixture()
def fault_state(monkeypatch):
    for var in ("DI_FAULTS", "DI_RETRY_MAX_ATTEMPTS", "DI_RETRY_DEADLINE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("DI_RETRY_BASE_DELAY", "0")
    monkeypatch.setenv("DI_RETRY_MAX_DELAY", "0")
    for f in (faults, jax_faults):
        f.reset()
    yield
    for f in (faults, jax_faults):
        f.reset()
    for mod in (native, jax_native):
        mod.reset()


def _redirect_build(mod, monkeypatch, tmp_path):
    native.reset()
    jax_native.reset()
    if mod is native:
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    else:
        monkeypatch.setattr(jax_native, "_BUILD_DIR", str(tmp_path))
        monkeypatch.setattr(jax_native, "_LIB_PATH", str(tmp_path / "geomfeats.so"))


@pytest.mark.parametrize("package", ["jax", "port"])
def test_native_compile_fault_is_retried(package, fault_state, monkeypatch, tmp_path):
    mod, fmod = (native, faults) if package == "port" else (jax_native, jax_faults)
    _redirect_build(mod, monkeypatch, tmp_path)
    fmod.configure({"native.compile": 1})  # the first compiler call faults
    assert mod.available() is True
    assert fmod.call_count("native.compile") == 2
    assert [p.name for p in tmp_path.iterdir() if p.suffix == ".tmp"] == []


@pytest.mark.parametrize("package", ["jax", "port"])
def test_native_latch_reason_and_reset(package, fault_state, monkeypatch, tmp_path):
    mod = native if package == "port" else jax_native
    _redirect_build(mod, monkeypatch, tmp_path)

    def broken(cmd):
        raise FileNotFoundError("g++ not found (injected)")

    monkeypatch.setattr(mod, "_run_compiler", broken)
    assert mod.available() is False
    assert "g++ not found" in mod.disabled_reason()
    assert mod.available() is False  # latched, no second compile
    mod.reset()
    assert mod.disabled_reason() is None


@pytest.mark.parametrize("package", ["jax", "port"])
def test_hhblits_fault_retry_policy(package, fault_state, fake_hhblits, tmp_path):
    mod, fmod = (postprocess, faults) if package == "port" else (jax_post, jax_faults)
    fmod.configure({"hhblits.run": 1})  # transient (exit 137): retried
    assert mod._run_hhblits("ACD", fake_hhblits, "/nonexistent/db")[0, 0] == 1.0
    assert fmod.call_count("hhblits.run") == 2
    fmod.configure({"hhblits.run": 99})  # every attempt: the budget of 3
    with pytest.raises(subprocess.CalledProcessError):
        mod._run_hhblits("ACD", fake_hhblits, "/nonexistent/db")
    assert fmod.call_count("hhblits.run") == 3
    script = tmp_path / "failing"
    script.write_text("#!/bin/sh\nexit 2\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    fmod.configure({"hhblits.run": 0})  # count only: exit 2 is deterministic
    with pytest.raises(subprocess.CalledProcessError):
        mod._run_hhblits("ACD", str(script), "/nonexistent/db")
    assert fmod.call_count("hhblits.run") == 1


# ---------------------------------------------------------------------------
# data/convert.py: reference processed dicts (plain-dict form) -> npz


def plain_graph(raw, interleave=False):
    """A featurized graph in the plain-dict form of a reference DGL graph:
    COO edges grouped by source, ``[E, 28, 1]`` edge features; with
    ``interleave`` the edges come in column-major order instead (the k-th
    edge of every source, then the next; flat edge ids in the neighbour
    arrays refer to that order), which the converter sorts back."""
    n, k = raw["nbr_idx"].shape
    src = np.repeat(np.arange(n), k)
    dst = raw["nbr_idx"].reshape(-1).astype(np.int64)
    ef = raw["edge_feats"].reshape(n * k, -1)[:, :, None]
    s_ids = raw["src_nbr_eids"].reshape(n * k, -1).astype(np.int64)
    d_ids = raw["dst_nbr_eids"].reshape(n * k, -1).astype(np.int64)
    if interleave:
        perm = np.arange(n * k).reshape(n, k).T.reshape(-1)  # new position -> old id
        new_id = np.empty_like(perm)
        new_id[perm] = np.arange(n * k)
        src, dst, ef = src[perm], dst[perm], ef[perm]
        s_ids, d_ids = new_id[s_ids[perm]], new_id[d_ids[perm]]
    return {"num_nodes": n, "edges": (src, dst),
            "ndata": {"f": raw["node_feats"], "x": raw["coords"]},
            "edata": {"f": ef, "src_nbr_e_ids": s_ids, "dst_nbr_e_ids": d_ids}}


def test_convert_tree_matches_jax(files, tmp_path):
    raw = pair.convert_pdb_pair_to_complex(files["left"], files["right"], knn=6,
                                           geo_nbrhd_size=2)
    src = tmp_path / "src"
    for rel, interleave in (("a/one.dill", False), ("b/c/two.dill", True)):
        (src / rel).parent.mkdir(parents=True, exist_ok=True)
        with open(src / rel, "wb") as f:
            pickle.dump({"graph1": plain_graph(raw["graph1"], interleave),
                         "graph2": plain_graph(raw["graph2"]),
                         "examples": raw["examples"], "complex": rel}, f)
    (src / "skip.txt").write_text("not a complex")
    assert jax_convert.convert_tree(str(src), str(tmp_path / "j")) == 2
    assert convert.convert_tree(str(src), str(tmp_path / "p")) == 2
    for rel in ("a/one.npz", "b/c/two.npz"):
        assert_npz_equal(tmp_path / "p" / rel, tmp_path / "j" / rel)
    # The re-sorted graph is the featurized one again.
    got = npz_arrays(tmp_path / "p" / "b/c/two.npz")
    for key, value in raw["graph1"].items():
        np.testing.assert_array_equal(got[f"g1_{key}"], value, err_msg=key)
    with zipfile.ZipFile(tmp_path / "p" / "a/one.npz") as z:
        assert "complex_name.npy" in z.namelist()


def test_convert_rejects_what_jax_rejects(files):
    raw = pair.convert_pdb_pair_to_complex(files["left"], files["right"], knn=6,
                                           geo_nbrhd_size=2)
    bad = plain_graph(raw["graph1"])
    bad["ndata"]["f"] = bad["ndata"]["f"][:, :100]
    for mod in (jax_convert, convert):
        with pytest.raises(ValueError, match="unexpected node feature width 100"):
            mod.reference_graph_to_raw(bad)
