"""Geometric featurization of protein chains (converter side, numpy).

A copy of ``deepinteract_tpu/data/features.py`` (the port imports
nothing of the JAX package). It makes the complexes that tests and
``chip_smoke.py`` feed the model on machines without jax.

Reimplements the reference's featurization semantics
(``project/utils/protein_feature_utils.py`` and
``convert_df_to_dgl_graph``, ``project/utils/deepinteract_utils.py:386-555``)
as pure numpy producing the dense ``[N, K]`` edge layout of
:mod:`deepinteract_tpu_torch.data.graph`. This runs once per complex on CPU; the
accelerator only ever sees the resulting padded arrays.

Numerics notes (kept for parity, flagged as reference quirks):
* RBF bins are applied to *squared* CA-CA distances with D_max=20
  (``protein_feature_utils.py:82-101`` fed from
  ``torch.topk(pairwise_squared_distance(...))``, ``graph_utils.py:110``).
* Dihedral padding removes phi[0], psi[-1], omega[-1]
  (``protein_feature_utils.py:276-320``).
* Edge weights and amide angles are min-max normalized per graph
  (``deepinteract_utils.py:506,513-530``).
* The per-edge geometric neighborhood (src/dst incident-edge ids) is randomly
  subsampled at data-prep time (``deepinteract_utils.py:532-553``) — the
  sampling lives here, NOT in the model, so jit-compiled compute stays
  deterministic.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from deepinteract_tpu_torch import constants

_EPS = 1e-7


def _normalize(v: np.ndarray, axis: int = -1, eps: float = 1e-12) -> np.ndarray:
    """Match ``torch.nn.functional.normalize``: x / max(||x||, eps)."""
    norm = np.linalg.norm(v, axis=axis, keepdims=True)
    return v / np.maximum(norm, eps)


def min_max_normalize(x: np.ndarray) -> np.ndarray:
    """Scale to [0, 1] (reference ``min_max_normalize_tensor``,
    deepinteract_utils.py:79-84). Constant input maps to 0 instead of NaN."""
    lo, hi = np.min(x), np.max(x)
    rng = hi - lo
    if rng == 0:
        return np.zeros_like(x, dtype=np.float32)
    return ((x - lo) / rng).astype(np.float32)


def knn_edges(coords: np.ndarray, k: int, self_loops: bool = True):
    """k-nearest-neighbor edges over CA coordinates.

    Returns (nbr_idx [N, k] int32 sorted by ascending distance,
    sq_dists [N, k] float32). With ``self_loops`` the first slot is the node
    itself (distance 0), matching ``dgl.knn_graph`` + squared-distance topk
    (``graph_utils.py:108-110``).
    """
    n = coords.shape[0]
    if (k if self_loops else k + 1) > n:
        raise ValueError(f"chain of length {n} cannot support knn={k} (self_loops={self_loops})")
    diff = coords[:, None, :] - coords[None, :, :]
    sq = np.sum(diff * diff, axis=-1)
    if not self_loops:
        np.fill_diagonal(sq, np.inf)
    order = np.argsort(sq, axis=1, kind="stable")[:, :k]
    return order.astype(np.int32), np.take_along_axis(sq, order, axis=1).astype(np.float32)


def dihedral_features(backbone: np.ndarray) -> np.ndarray:
    """Per-residue (cos, sin) of phi/psi/omega from N,CA,C coords.

    backbone: [N, 4, 3] (N, CA, C, O). Returns [N, 6].
    Reference: ``GeometricProteinFeatures.get_dihedrals``
    (protein_feature_utils.py:276-320), including its padding scheme that
    zeroes phi[0], psi[-1], omega[-1].
    """
    n = backbone.shape[0]
    x = backbone[:, :3, :].reshape(3 * n, 3)
    dx = x[1:] - x[:-1]
    u = _normalize(dx)
    u_2, u_1, u_0 = u[:-2], u[1:-1], u[2:]
    n_2 = _normalize(np.cross(u_2, u_1))
    n_1 = _normalize(np.cross(u_1, u_0))
    cos_d = np.clip(np.sum(n_2 * n_1, axis=-1), -1 + _EPS, 1 - _EPS)
    d = np.sign(np.sum(u_2 * n_1, axis=-1)) * np.arccos(cos_d)
    d = np.pad(d, (1, 2))
    d = d.reshape(n, 3)
    return np.concatenate([np.cos(d), np.sin(d)], axis=1).astype(np.float32)


def rbf_features(sq_dists: np.ndarray, num_rbf: int = constants.NUM_RBF) -> np.ndarray:
    """Radial basis features over (squared) distances, D in [0, 20].

    Reference: ``GeometricProteinFeatures.compute_rbfs``
    (protein_feature_utils.py:82-101); note the squared-distance input quirk.
    """
    d_mu = np.linspace(0.0, 20.0, num_rbf)
    d_sigma = 20.0 / num_rbf
    z = (sq_dists[..., None] - d_mu) / d_sigma
    return np.exp(-(z ** 2)).astype(np.float32)


def local_frames(ca: np.ndarray) -> np.ndarray:
    """Per-residue local orthogonal frame O [N, 3, 3] from backbone-adjacent
    CA unit vectors; rows (o_1, n_2, o_1 x n_2). First row and last two rows
    are zero (reference padding, protein_feature_utils.py:227-236)."""
    dx = ca[1:] - ca[:-1]
    u = _normalize(dx)
    u_2, u_1 = u[:-2], u[1:-1]
    n_2 = _normalize(np.cross(u_2, u_1))
    o_1 = _normalize(u_2 - u_1)
    frames = np.stack([o_1, n_2, np.cross(o_1, n_2)], axis=1)  # [N-3, 3, 3]
    return np.pad(frames, ((1, 2), (0, 0), (0, 0))).astype(np.float32)


def rotations_to_quaternions(r: np.ndarray) -> np.ndarray:
    """Rotation matrices [..., 3, 3] -> unit quaternions [..., 4] (x,y,z,w).

    Reference: ``convert_rotations_into_quaternions``
    (protein_feature_utils.py:104-149), including sign(0)=0 behavior.
    """
    rxx, ryy, rzz = r[..., 0, 0], r[..., 1, 1], r[..., 2, 2]
    magnitudes = 0.5 * np.sqrt(
        np.abs(1 + np.stack([rxx - ryy - rzz, -rxx + ryy - rzz, -rxx - ryy + rzz], axis=-1))
    )
    signs = np.sign(
        np.stack(
            [
                r[..., 2, 1] - r[..., 1, 2],
                r[..., 0, 2] - r[..., 2, 0],
                r[..., 1, 0] - r[..., 0, 1],
            ],
            axis=-1,
        )
    )
    xyz = signs * magnitudes
    trace = rxx + ryy + rzz
    w = np.sqrt(np.maximum(1 + trace, 0.0))[..., None] / 2.0
    q = np.concatenate([xyz, w], axis=-1)
    return _normalize(q).astype(np.float32)


def orientation_features(ca: np.ndarray, nbr_idx: np.ndarray):
    """Per-edge local-frame direction dU [N,K,3] and relative-orientation
    quaternion Q [N,K,4] (reference ``get_coarse_orientation_feats``,
    protein_feature_utils.py:201-273)."""
    frames = local_frames(ca)  # [N, 3, 3]
    x_nbr = ca[nbr_idx]  # [N, K, 3]
    o_nbr = frames[nbr_idx]  # [N, K, 3, 3]
    dx = x_nbr - ca[:, None, :]
    du = _normalize(np.einsum("nij,nkj->nki", frames, dx))
    rel_r = np.einsum("nji,nkjl->nkil", frames, o_nbr)  # O_i^T @ O_j
    quat = rotations_to_quaternions(rel_r)
    return du.astype(np.float32), quat


def amide_normal_vectors(backbone: np.ndarray, cb: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-residue amide-plane normal vector [N, 3].

    Reference computes cross(CA-CB, CB-N) from real CB atoms
    (``dips_plus_utils.py:356-374``, NaN when CB is missing, e.g. glycine).
    When CB coordinates are unavailable we substitute a virtual CB placed from
    the backbone frame, which keeps the feature well-defined for every residue.
    """
    n_at, ca, c_at = backbone[:, 0], backbone[:, 1], backbone[:, 2]
    if cb is None:
        # Virtual CB via standard tetrahedral construction.
        b1 = _normalize(ca - n_at)
        b2 = _normalize(c_at - ca)
        axis = _normalize(np.cross(b1, b2))
        cb = ca - 0.58273431 * (b1 + b2) + 0.56802827 * axis
    vec1 = ca - cb
    vec2 = cb - n_at
    return np.cross(vec1, vec2).astype(np.float32)


def amide_angle_features(norm_vecs: np.ndarray, nbr_idx: np.ndarray) -> np.ndarray:
    """Min-max-normalized angle between src and dst amide normals per edge
    [N, K] (reference: deepinteract_utils.py:513-530, NaN -> 0). The angle is
    symmetric in the two endpoints."""
    v_src = np.broadcast_to(norm_vecs[:, None, :], (*nbr_idx.shape, 3))  # center i
    v_dst = norm_vecs[nbr_idx]  # neighbor
    denom = np.linalg.norm(v_dst, axis=-1) * np.linalg.norm(v_src, axis=-1)
    with np.errstate(invalid="ignore", divide="ignore"):
        cos = np.sum(v_dst * v_src, axis=-1) / denom
        angles = np.arccos(np.clip(cos, -1.0, 1.0))
    angles = np.nan_to_num(angles, nan=0.0)
    return np.nan_to_num(min_max_normalize(angles), nan=0.0)


def sample_geo_neighborhoods(nbr_idx: np.ndarray, geo_nbrhd_size: int, rng: np.random.Generator):
    """For each edge (i, k) — source/center i, destination j = nbr_idx[i, k] —
    sample flat ids of ``geo_nbrhd_size`` edges incident to i (src side) and
    to j (dst side), drawn from each node's own K-edge row.

    Reference: the shuffled incident-edge subsampling at
    ``deepinteract_utils.py:532-553`` (flat edge id of (i, k) is i*K + k);
    see ``graph.ProteinGraph`` for the documented in-edge -> out-edge
    deviation.

    Distributional note: the permutation over row i's K slots can select the
    edge's *own* slot k as one of its "neighboring" edges, and for a
    self-loop edge (j == i) the dst-side draw samples the same row as the
    src side. The reference samples from shuffled in-edge lists, where the
    same degenerate picks occur but with a different distribution; exact
    sampling parity is not a goal (this runs once, in data prep).
    """
    n, k = nbr_idx.shape
    g = geo_nbrhd_size
    # Independent slot permutations per edge, truncated to g.
    src_slots = np.argsort(rng.random((n, k, k)), axis=-1)[..., :g].astype(np.int32)
    dst_slots = np.argsort(rng.random((n, k, k)), axis=-1)[..., :g].astype(np.int32)
    src_nbr_eids = (np.arange(n, dtype=np.int32)[:, None, None]) * k + src_slots  # row of source i
    dst_nbr_eids = nbr_idx[:, :, None] * k + dst_slots  # row of destination j
    return src_nbr_eids.astype(np.int32), dst_nbr_eids.astype(np.int32)


def featurize_chain(
    backbone: np.ndarray,
    residue_feats: np.ndarray,
    knn: int = constants.KNN,
    geo_nbrhd_size: int = constants.GEO_NBRHD_SIZE,
    self_loops: bool = True,
    amide_norm_vecs: Optional[np.ndarray] = None,
    rng: Optional[np.random.Generator] = None,
) -> Dict[str, np.ndarray]:
    """Full per-chain featurization -> dict of unpadded arrays.

    Args:
      backbone: [N, 4, 3] N/CA/C/O coordinates (NaNs allowed; zero-masked as
        in the reference, deepinteract_utils.py:470-473).
      residue_feats: [N, 106] DIPS-Plus residue features (columns 7..113 of
        the node schema).

    Returns dict consumable by :func:`deepinteract_tpu_torch.data.graph.pad_graph`.
    """
    rng = rng or np.random.default_rng(0)
    n = backbone.shape[0]
    if residue_feats.shape != (n, constants.NUM_NODE_FEATS - 7):
        raise ValueError(f"residue_feats must be [N, 106], got {residue_feats.shape}")

    backbone = np.nan_to_num(backbone, nan=0.0).astype(np.float32)
    ca = backbone[:, 1, :]

    nbr_idx, sq_dists = knn_edges(ca, knn, self_loops=self_loops)

    # Node features: [pos_enc | dihedrals(6) | DIPS-Plus(106)]
    pos_enc = min_max_normalize(np.arange(n, dtype=np.float32))[:, None]
    node_feats = np.concatenate(
        [pos_enc, dihedral_features(backbone), residue_feats.astype(np.float32)], axis=1
    )

    # Edge features: [sin(src-dst) | weight | rbf(18) | dir(3) | quat(4) | amide]
    # src = center i, dst = nbr_idx[i, k] (reference: deepinteract_utils.py:503).
    edge_pos_enc = np.sin((np.arange(n, dtype=np.int32)[:, None] - nbr_idx).astype(np.float32))
    edge_weights = min_max_normalize(sq_dists).reshape(n, knn)
    rbf = rbf_features(sq_dists)
    du, quat = orientation_features(ca, nbr_idx)
    if amide_norm_vecs is None:
        amide_norm_vecs = amide_normal_vectors(backbone)
    amide = amide_angle_features(amide_norm_vecs, nbr_idx)
    edge_feats = np.concatenate(
        [edge_pos_enc[..., None], edge_weights[..., None], rbf, du, quat, amide[..., None]],
        axis=-1,
    ).astype(np.float32)
    assert edge_feats.shape == (n, knn, constants.NUM_EDGE_FEATS)

    src_nbr_eids, dst_nbr_eids = sample_geo_neighborhoods(nbr_idx, geo_nbrhd_size, rng)

    return {
        "node_feats": node_feats,
        "coords": ca,
        "edge_feats": edge_feats,
        "nbr_idx": nbr_idx,
        "src_nbr_eids": src_nbr_eids,
        "dst_nbr_eids": dst_nbr_eids,
    }
