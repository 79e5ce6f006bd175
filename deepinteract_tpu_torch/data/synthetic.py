"""Synthetic protein-complex generator for tests and the chip smoke run.

Numpy copy of ``deepinteract_tpu/data/synthetic.py``: a 3.8 Å-step smooth
CA walk with ideal-ish backbone geometry, DIPS-Plus-like residue
features, and contact labels from an 8 Å inter-chain CA cutoff. The same
seed gives the same complex as the JAX package's generator.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

from deepinteract_tpu_torch import constants
from deepinteract_tpu_torch.data import features as F
from deepinteract_tpu_torch.data.graph import PairedComplex
from deepinteract_tpu_torch.data.io import save_complex_npz, to_paired_complex


def random_backbone(n: int, rng: np.random.Generator, origin=None) -> np.ndarray:
    """[N, 4, 3] N/CA/C/O coords along a smooth random CA trace."""
    steps = rng.normal(size=(n, 3))
    # Smooth the walk so it locally resembles secondary structure.
    for axis in range(3):
        steps[:, axis] = np.convolve(steps[:, axis], np.ones(4) / 4.0, mode="same")
    steps = steps / np.maximum(np.linalg.norm(steps, axis=1, keepdims=True), 1e-9) * 3.8
    ca = np.cumsum(steps, axis=0)
    if origin is not None:
        ca = ca - ca.mean(axis=0) + origin
    # Ideal-ish offsets for N, C, O around each CA in a wobbly local frame.
    t = np.arange(n)[:, None]
    wob = np.stack([np.sin(t * 1.7), np.cos(t * 1.3), np.sin(t * 0.9 + 1.0)], axis=-1)[:, 0, :]
    wob = wob / np.maximum(np.linalg.norm(wob, axis=1, keepdims=True), 1e-9)
    n_at = ca - 1.46 * wob
    c_at = ca + 1.52 * np.roll(wob, 1, axis=0)
    o_at = c_at + 1.23 * wob
    return np.stack([n_at, ca, c_at, o_at], axis=1).astype(np.float32)


def random_residue_feats(n: int, rng: np.random.Generator) -> np.ndarray:
    """[N, 106] DIPS-Plus-like residue features matching the node schema."""
    feats = np.zeros((n, constants.NUM_NODE_FEATS - 7), dtype=np.float32)
    off = 7  # schema offsets below are absolute; subtract node prefix

    def sl(s):  # absolute slice -> local
        return slice(s.start - off, s.stop - off)

    resname = rng.integers(0, 20, size=n)
    feats[np.arange(n), sl(constants.NODE_RESNAME_ONE_HOT).start + resname] = 1.0
    ss = rng.integers(0, 8, size=n)
    feats[np.arange(n), sl(constants.NODE_SS_ONE_HOT).start + ss] = 1.0
    feats[:, constants.NODE_RSA - off] = rng.random(n)
    feats[:, constants.NODE_RD - off] = rng.random(n)
    feats[:, sl(constants.NODE_PROTRUSION)] = rng.random((n, 6))
    hsaac = rng.random((n, constants.HSAAC_DIM))
    feats[:, sl(constants.NODE_HSAAC)] = hsaac / hsaac.sum(axis=1, keepdims=True)
    feats[:, constants.NODE_CN - off] = rng.random(n)
    feats[:, sl(constants.NODE_SEQUENCE_FEATS)] = rng.random((n, constants.NUM_SEQUENCE_FEATS))
    return feats


def random_raw_complex(n1: int, n2: int, rng: np.random.Generator,
                       knn: int = constants.KNN,
                       geo_nbrhd_size: int = constants.GEO_NBRHD_SIZE,
                       contact_cutoff: float = 8.0) -> dict:
    """Un-padded raw complex dict (``{"graph1", "graph2", "examples"}``),
    the shape ``data.io.load_complex_npz`` returns."""
    raws, cas = [], []
    for n, origin in ((n1, np.zeros(3)), (n2, np.array([10.0, 0.0, 0.0]))):
        bb = random_backbone(n, rng, origin=origin)
        raws.append(F.featurize_chain(
            bb, random_residue_feats(n, rng), knn=knn,
            geo_nbrhd_size=geo_nbrhd_size, rng=rng))
        cas.append(bb[:, 1, :])
    d = np.linalg.norm(cas[0][:, None] - cas[1][None, :], axis=-1)
    contact = (d < contact_cutoff).astype(np.int32)
    ii, jj = np.meshgrid(np.arange(n1), np.arange(n2), indexing="ij")
    examples = np.stack([ii.ravel(), jj.ravel(), contact.ravel()],
                        axis=1).astype(np.int32)
    return {"graph1": raws[0], "graph2": raws[1], "examples": examples}


def write_tiny_npz_dataset(root: str, n_complexes: int = 5, n1: int = 24, n2: int = 21,
                           seed: int = 0, knn: int = 6, geo_nbrhd_size: int = 2,
                           sizes: Optional[Sequence[Tuple[int, int]]] = None) -> None:
    """Write a small on-disk DIPS-style dataset (``processed/`` npz tree
    and split files) that ``cli.train --dips_root`` reads. All complexes
    are in the train split; val and test hold the first one. With the
    defaults it writes the same files as the JAX package's
    ``write_tiny_npz_dataset``; ``sizes`` gives each complex its own
    (n1, n2) instead (and then sets their number)."""
    processed = os.path.join(root, "processed")
    os.makedirs(processed, exist_ok=True)
    rng = np.random.default_rng(seed)
    sizes = list(sizes) if sizes is not None else [(n1, n2)] * n_complexes
    names = []
    for i, (a, b) in enumerate(sizes):
        raw = random_raw_complex(a, b, rng, knn=knn, geo_nbrhd_size=geo_nbrhd_size)
        name = f"c{i}.npz"
        save_complex_npz(os.path.join(processed, name), raw["graph1"], raw["graph2"],
                         raw["examples"], complex_name=f"c{i}")
        names.append(name)
    for mode, sel in (("train", names), ("val", names[:1]), ("test", names[:1])):
        with open(os.path.join(root, f"pairs-postprocessed-{mode}.txt"), "w") as f:
            f.write("\n".join(sel) + "\n")


def random_complex(
    n1: int,
    n2: int,
    rng: Optional[np.random.Generator] = None,
    n_pad1: Optional[int] = None,
    n_pad2: Optional[int] = None,
    knn: int = constants.KNN,
    geo_nbrhd_size: int = constants.GEO_NBRHD_SIZE,
    contact_cutoff: float = 8.0,
) -> PairedComplex:
    """A padded two-chain complex with geometric contact labels (CPU
    tensors). Draws from ``rng`` in the same order as the JAX package's
    ``random_complex``, so one seed gives one complex in both."""
    rng = rng or np.random.default_rng(0)
    raw = random_raw_complex(n1, n2, rng, knn, geo_nbrhd_size, contact_cutoff)
    return to_paired_complex(raw, n_pad1, n_pad2)
