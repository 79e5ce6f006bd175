"""The port's training data and metrics against the JAX package's: the
metric suite (training/metrics.py), the tiny on-disk dataset writer, the
DIPS/DB5/CASP-CAPRI split wiring and the bucketed loader's plan."""

import os

import numpy as np
import pytest

from deepinteract_tpu.data import datasets as jax_datasets
from deepinteract_tpu.data.io import load_complex_npz as jax_load_complex_npz
from deepinteract_tpu.data.loader import BucketedLoader as JaxBucketedLoader
from deepinteract_tpu.data.synthetic import write_tiny_npz_dataset as jax_write_tiny
from deepinteract_tpu.training import metrics as jax_metrics
from deepinteract_tpu_torch.data import datasets
from deepinteract_tpu_torch.data.io import load_complex_npz
from deepinteract_tpu_torch.data.loader import BucketedLoader, make_bucket_fn
from deepinteract_tpu_torch.data.synthetic import write_tiny_npz_dataset
from deepinteract_tpu_torch.training import metrics

TOL = dict(rtol=1e-12, atol=1e-12)
# Chains across the 64/128/192/256 buckets.
SIZES = ((24, 21), (70, 30), (100, 140), (30, 20), (60, 62), (130, 90), (25, 200), (66, 70))


def _probs_labels(seed, n1=23, n2=17, ties=False):
    rng = np.random.default_rng(seed)
    probs = rng.random(n1 * n2)
    if ties:
        probs = np.round(probs, 1)
    labels = (rng.random(n1 * n2) < 0.15).astype(np.int64)
    return probs, labels


@pytest.mark.parametrize("stage", ["val", "test"])
@pytest.mark.parametrize("ties", [False, True])
def test_metrics_match_jax(stage, ties):
    per_complex, ref = [], []
    for seed in range(4):
        probs, labels = _probs_labels(seed, ties=ties)
        per_complex.append(metrics.complex_metrics(probs, labels, 23, 17, stage, ce=0.1 * seed))
        ref.append(jax_metrics.complex_metrics(probs, labels, 23, 17, stage, ce=0.1 * seed))
    for ours, theirs in zip(per_complex, ref):
        assert ours.keys() == theirs.keys()
        np.testing.assert_allclose([ours[k] for k in ours], [theirs[k] for k in ours], **TOL)
    agg, agg_ref = metrics.aggregate_median(per_complex), jax_metrics.aggregate_median(ref)
    assert agg.keys() == agg_ref.keys()
    np.testing.assert_allclose([agg[k] for k in agg], [agg_ref[k] for k in agg], **TOL)


def test_gather_and_csv_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    probs = rng.random((6, 5, 2))
    examples = np.stack([rng.integers(0, 6, 20), rng.integers(0, 5, 20),
                         rng.integers(0, 2, 20)], -1)
    mask = rng.random(20) < 0.7
    for a, b in zip(metrics.gather_pair_predictions(probs, examples, mask),
                    jax_metrics.gather_pair_predictions(probs, examples, mask)):
        np.testing.assert_array_equal(a, b)
    rows = [metrics.complex_metrics(*_probs_labels(s), 23, 17, "test") for s in range(3)]
    metrics.write_topk_csv(rows, ["a", "b", "c"], str(tmp_path / "ours.csv"))
    jax_metrics.write_topk_csv(rows, ["a", "b", "c"], str(tmp_path / "ref.csv"))
    assert (tmp_path / "ours.csv").read_text() == (tmp_path / "ref.csv").read_text()
    assert [p.name for p in tmp_path.iterdir() if p.name.startswith(".tmp")] == []


def test_tiny_dataset_writer_matches_jax(tmp_path):
    """The defaults write the JAX package's files array for array; splits
    and lengths read back the same through both dataset classes."""
    jax_write_tiny(str(tmp_path / "jax"), n_complexes=3)
    write_tiny_npz_dataset(str(tmp_path / "port"), n_complexes=3)
    for mode in ("train", "val", "test"):
        name = f"pairs-postprocessed-{mode}.txt"
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    ours = datasets.DIPSDataset(str(tmp_path / "port"), "train")
    ref = jax_datasets.DIPSDataset(str(tmp_path / "jax"), "train")
    assert len(ours) == len(ref) == 3 and ours.lengths() == ref.lengths()
    for i in range(3):
        a, b = load_complex_npz(ours.path_of(i)), jax_load_complex_npz(ref.path_of(i))
        for g in ("graph1", "graph2"):
            for key, value in a[g].items():
                np.testing.assert_array_equal(value, b[g][key])
        np.testing.assert_array_equal(a["examples"], b["examples"])
        assert ours[i]["target"] == ref[i]["target"] == f"c{i}"


def test_data_module_splits_and_percent_sample_match_jax(tmp_path):
    root = str(tmp_path)
    write_tiny_npz_dataset(root, sizes=SIZES)
    ours = datasets.PICPDataModule(dips_root=root, percent_to_use=0.5, seed=3)
    ref = jax_datasets.PICPDataModule(dips_root=root, percent_to_use=0.5, seed=3)
    for split in ("train", "val", "test"):
        assert getattr(ours, split).filenames == getattr(ref, split).filenames
        assert getattr(ours, split).name == "DIPS-Plus"
    assert os.path.exists(os.path.join(root, "pairs-postprocessed-train-50%.txt"))
    casp = datasets.PICPDataModule(dips_root=root, casp_capri_root=root,
                                   test_with_casp_capri=True)
    assert casp.test.name == "CASP-CAPRI"
    with pytest.raises(ValueError):
        datasets.CASPCAPRIDataset(root, mode="train")


@pytest.mark.parametrize("batch_size,shuffle,drop_remainder,flags",
                         [(1, True, True, {}), (2, True, True, {}), (2, False, False, {}),
                          (3, True, False, {"diagonal_buckets": True}),
                          (2, True, True, {"pad_to_max_bucket": True})])
def test_loader_plan_matches_jax(tmp_path, batch_size, shuffle, drop_remainder, flags):
    """Bucket keys, per-epoch batch order under a seed and num_batches, on
    one written tree (the JAX loader with per-step dispatch, no prefetch)."""
    write_tiny_npz_dataset(str(tmp_path), sizes=SIZES)
    kw = dict(batch_size=batch_size, shuffle=shuffle, drop_remainder=drop_remainder, seed=7,
              **flags)
    ours = BucketedLoader(datasets.DIPSDataset(str(tmp_path), "train"), **kw)
    ref = JaxBucketedLoader(jax_datasets.DIPSDataset(str(tmp_path), "train"), prefetch=0, **kw)
    assert ours._buckets == ref._buckets
    assert ours.num_batches() == ref.num_batches()
    for epoch in range(3):
        assert ours.epoch_plan(epoch) == ref._epoch_plan(epoch)
    assert ours.targets() == ref.targets()
    batches = list(ours(1))
    assert len(batches) == ours.num_batches()
    for batch, (bucket, chunk) in zip(batches, ours.epoch_plan(1)):
        assert tuple(batch.contact_map.shape) == (len(chunk), *bucket)
    assert make_bucket_fn(diagonal_buckets=True)(25, 200) == (256, 256)
