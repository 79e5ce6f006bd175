"""PDB pair -> 113/28-schema graph pair (+ optional interface labels).

Port of ``deepinteract_tpu/pipeline/pair.py`` (the port imports nothing
of the JAX package); every function gives the same arrays on the same
input.

End-to-end equivalent of the reference's
``convert_input_pdb_files_to_pair`` -> ``process_pdb_into_graph`` front end
(deepinteract_utils.py:794-862): parse both PDB files, compute DIPS-Plus
residue features (pipeline.postprocess), run geometric featurization
(data.features.featurize_chain), and emit the npz complex consumed by the
datasets/loader/predict paths.

Labels: for bound complexes, positives are residue pairs whose minimum
heavy-atom distance is below 6 A — atom3's ``get_neighbors`` criterion the
reference's pruned pairs (``pos_idx``) are built with (SURVEY.md §2.3,
make_dataset at deepinteract_utils.py:611-628). Unbound inference inputs
skip labels (all-zero examples, like the reference's ``input`` source type).
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np

from deepinteract_tpu_torch import constants
from deepinteract_tpu_torch.data.features import featurize_chain
from deepinteract_tpu_torch.data.io import save_complex_npz
from deepinteract_tpu_torch.pipeline import native
from deepinteract_tpu_torch.pipeline.pdb import Chain, merge_chains, parse_pdb_chains
from deepinteract_tpu_torch.pipeline.postprocess import (
    amide_normal_vectors_for_chain,
    compute_residue_features,
)

logger = logging.getLogger(__name__)

INTERFACE_CUTOFF = 6.0  # A, atom3 pruned-pair neighbor criterion


def load_structure(path: str, chain_id: Optional[str] = None) -> Chain:
    """One PDB file -> one structure (all chains merged unless one is
    selected), mirroring the reference's per-file DataFrames df0/df1."""
    chains = parse_pdb_chains(path, chain_ids=[chain_id] if chain_id else None)
    if not chains:
        raise ValueError(f"no parseable protein chains in {path}")
    if chain_id:
        return chains[chain_id]
    if len(chains) == 1:
        return next(iter(chains.values()))
    return merge_chains([chains[k] for k in sorted(chains)])


def interface_labels(chain1: Chain, chain2: Chain,
                     use_native: Optional[bool] = None) -> np.ndarray:
    """[R1, R2] 0/1 contact map at the 6 A heavy-atom cutoff."""
    if use_native is None:
        use_native = native.available()
    if use_native:
        d = native.cross_min_dist_matrix(
            chain1.coords, chain1.atom_start, chain2.coords, chain2.atom_start
        )
    else:
        full = np.sqrt(np.maximum(np.sum(
            (chain1.coords[:, None, :] - chain2.coords[None, :, :]) ** 2, axis=-1
        ), 0.0))
        d = np.minimum.reduceat(full, chain1.atom_start[:-1], axis=0)
        d = np.minimum.reduceat(d, chain2.atom_start[:-1], axis=1)
    return (d < INTERFACE_CUTOFF).astype(np.int32)


def build_examples(contact_map: np.ndarray) -> np.ndarray:
    """Dense [R1*R2, 3] (i, j, label) example list — the reference's
    ``build_examples_tensor`` flattening (deepinteract_utils.py:558-582)."""
    r1, r2 = contact_map.shape
    ii, jj = np.meshgrid(np.arange(r1), np.arange(r2), indexing="ij")
    return np.stack(
        [ii.ravel(), jj.ravel(), contact_map.ravel()], axis=1
    ).astype(np.int32)


def featurize_structure(
    chain: Chain,
    knn: int = constants.KNN,
    geo_nbrhd_size: int = constants.GEO_NBRHD_SIZE,
    use_native: Optional[bool] = None,
    rng: Optional[np.random.Generator] = None,
    sequence_feats: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """One parsed structure -> unpadded graph arrays (113/28 schema)."""
    residue_feats = compute_residue_features(
        chain, use_native=use_native, sequence_feats=sequence_feats
    )
    return featurize_chain(
        chain.backbone(),
        residue_feats,
        knn=knn,
        geo_nbrhd_size=geo_nbrhd_size,
        amide_norm_vecs=amide_normal_vectors_for_chain(chain),
        rng=rng,
    )


def convert_bound_complex_to_pair(
    pdb_path: str,
    chain1: str,
    chain2: str,
    output_npz: Optional[str] = None,
    **kwargs,
) -> Dict:
    """One bound-complex PDB + two chain ids -> labeled complex.

    The single-file analog of the DIPS builder flow (atom3 ``make_dataset``
    parses bound RCSB complexes into chain pairs pruned at the 6 A
    interface criterion, deepinteract_utils.py:611-628). Accepts the same
    keyword arguments as :func:`convert_pdb_pair_to_complex`.
    """
    chains = parse_pdb_chains(pdb_path)
    for cid in (chain1, chain2):
        if cid not in chains:
            raise ValueError(
                f"chain {cid!r} not found in {pdb_path}; has {sorted(chains)}"
            )
    kwargs.setdefault("complex_name", f"{pdb_path}:{chain1}-{chain2}")
    return _convert_structures(
        chains[chain1], chains[chain2], output_npz=output_npz, **kwargs,
    )


def convert_pdb_pair_to_complex(
    left_pdb: str,
    right_pdb: str,
    output_npz: Optional[str] = None,
    with_labels: bool = True,
    knn: int = constants.KNN,
    geo_nbrhd_size: int = constants.GEO_NBRHD_SIZE,
    use_native: Optional[bool] = None,
    seed: int = 42,
    complex_name: str = "",
) -> Dict:
    """Two PDB files -> raw complex dict (optionally persisted as npz).

    The returned dict matches ``data.io.load_complex_npz`` output, so it
    feeds directly into ``to_paired_complex`` -> model.
    """
    return _convert_structures(
        load_structure(left_pdb),
        load_structure(right_pdb),
        output_npz=output_npz,
        with_labels=with_labels,
        knn=knn,
        geo_nbrhd_size=geo_nbrhd_size,
        use_native=use_native,
        seed=seed,
        complex_name=complex_name or f"{left_pdb}:{right_pdb}",
    )


def _convert_structures(
    chain1: Chain,
    chain2: Chain,
    output_npz: Optional[str] = None,
    with_labels: bool = True,
    knn: int = constants.KNN,
    geo_nbrhd_size: int = constants.GEO_NBRHD_SIZE,
    use_native: Optional[bool] = None,
    seed: int = 42,
    complex_name: str = "",
) -> Dict:
    for name, ch in (("left", chain1), ("right", chain2)):
        if ch.num_atoms > constants.ATOM_COUNT_LIMIT:
            logger.warning(
                "%s structure has %d atoms (> ATOM_COUNT_LIMIT=%d); the "
                "reference filters such complexes out of training sets",
                name, ch.num_atoms, constants.ATOM_COUNT_LIMIT,
            )
    rng = np.random.default_rng(seed)
    raw1 = featurize_structure(chain1, knn, geo_nbrhd_size, use_native, rng)
    raw2 = featurize_structure(chain2, knn, geo_nbrhd_size, use_native, rng)
    if with_labels:
        contact_map = interface_labels(chain1, chain2, use_native)
    else:
        contact_map = np.zeros((len(chain1), len(chain2)), dtype=np.int32)
    examples = build_examples(contact_map)
    if output_npz:
        save_complex_npz(output_npz, raw1, raw2, examples, complex_name=complex_name)
    return {
        "graph1": raw1, "graph2": raw2, "examples": examples,
        "complex_name": complex_name,
    }
