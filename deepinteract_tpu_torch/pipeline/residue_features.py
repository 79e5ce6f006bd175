"""Per-residue structural features: RSA, secondary structure, depth, CX, HSAAC/CN.

Port of ``deepinteract_tpu/pipeline/residue_features.py`` (the port imports nothing
of the JAX package); every function gives the same arrays on the same
input.

In-repo replacements for the reference's four native feature binaries
(SURVEY.md §2.3; invoked at deepinteract_utils.py:690-718 and
dips_plus_utils.py:215-243):

* DSSP  -> Kabsch-Sander H-bond energies + 8-state assignment over backbone
  coordinates (``assign_secondary_structure``) and Shrake-Rupley SASA
  normalized by per-residue max ASA (``relative_solvent_accessibility``).
* MSMS  -> depth below the solvent-accessible surface
  (``sasa_and_depth``); consumed min-max normalized per chain
  (dips_plus_utils.py:566), so only the ordering matters.
* PSAIA -> per-atom protrusion index CX aggregated into the 6 PSAIA table
  stats (``protrusion_stats``); also normalized per chain.
* PAIRpred (pure-Python in the reference, dips_plus_utils.py:84-161) ->
  ``similarity_matrix``/``hsaac`` with the same sigma-2 Gaussian similarity,
  threshold, and up/down half-sphere bookkeeping (self counted "down",
  matching the reference's NaN-angle branch).

Every O(n^2) kernel has two paths: the native C++ library
(:mod:`deepinteract_tpu_torch.pipeline.native`) and the vectorized numpy
fallback here; ``use_native=None`` auto-selects.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from deepinteract_tpu_torch import constants
from deepinteract_tpu_torch.pipeline import native
from deepinteract_tpu_torch.pipeline.pdb import Chain

# Van der Waals radii by element (Bondi), probe 1.4 A as in DSSP/NACCESS.
VDW_RADII = {"C": 1.70, "N": 1.55, "O": 1.52, "S": 1.80, "P": 1.80, "SE": 1.90}
DEFAULT_RADIUS = 1.70
PROBE_RADIUS = 1.4
N_SPHERE = 92

# Max accessible surface area per residue (Sander & Rost 1994), the table
# DSSP-style RSA divides by.
MAX_ASA = {
    "ALA": 106.0, "ARG": 248.0, "ASN": 157.0, "ASP": 163.0, "CYS": 135.0,
    "GLN": 198.0, "GLU": 194.0, "GLY": 84.0, "HIS": 184.0, "ILE": 169.0,
    "LEU": 164.0, "LYS": 205.0, "MET": 188.0, "PHE": 197.0, "PRO": 136.0,
    "SER": 130.0, "THR": 142.0, "TRP": 227.0, "TYR": 222.0, "VAL": 142.0,
}
DEFAULT_MAX_ASA = 180.0

# PSAIA defaults: 10 A sphere, 20.1 A^3 average heavy-atom volume.
CX_SPHERE_RADIUS = 10.0
CX_ATOM_VOLUME = 20.1

_AA_IDX = {aa: i for i, aa in enumerate(constants.AMINO_ACIDS)}


def _use_native(use_native: Optional[bool]) -> bool:
    if use_native is None:
        return native.available()
    if use_native and not native.available():
        raise RuntimeError("native geometry library requested but unavailable")
    return use_native


def atom_radii(elements: Sequence[str]) -> np.ndarray:
    return np.asarray(
        [VDW_RADII.get(e, DEFAULT_RADIUS) for e in elements], dtype=np.float32
    )


def fibonacci_sphere(n: int) -> np.ndarray:
    """Golden-spiral unit sphere points — same formula as geomfeats.cpp."""
    i = np.arange(n, dtype=np.float32)
    golden = np.float32(np.pi * (3.0 - np.sqrt(5.0)))
    y = 1.0 - 2.0 * (i + 0.5) / n
    r = np.sqrt(np.maximum(0.0, 1.0 - y * y))
    th = golden * i
    return np.stack([np.cos(th) * r, y, np.sin(th) * r], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# SASA + depth (numpy fallback of geomfeats.cpp::sasa_and_depth)
# ---------------------------------------------------------------------------

def _sasa_and_depth_numpy(coords: np.ndarray, radii: np.ndarray,
                          n_sphere: int = N_SPHERE, probe: float = PROBE_RADIUS):
    n = coords.shape[0]
    unit = fibonacci_sphere(n_sphere)
    inflated = radii + probe
    sasa = np.zeros(n, dtype=np.float32)
    surface: List[np.ndarray] = []
    sq = np.sum(
        (coords[:, None, :] - coords[None, :, :]) ** 2, axis=-1
    )
    for i in range(n):
        lim = (inflated[i] + radii + probe) ** 2
        nbrs = np.flatnonzero((sq[i] < lim) & (np.arange(n) != i))
        pts = coords[i] + inflated[i] * unit  # [S, 3]
        if nbrs.size:
            d2 = np.sum((pts[:, None, :] - coords[nbrs][None, :, :]) ** 2, axis=-1)
            buried = np.any(d2 < (inflated[nbrs] ** 2)[None, :], axis=1)
        else:
            buried = np.zeros(n_sphere, dtype=bool)
        acc = ~buried
        sasa[i] = 4.0 * np.pi * inflated[i] ** 2 * acc.sum() / n_sphere
        if acc.any():
            surface.append(pts[acc])
    if surface:
        surf = np.concatenate(surface, axis=0)
        depth = np.empty(n, dtype=np.float32)
        for start in range(0, n, 256):
            chunk = coords[start : start + 256]
            d2 = np.sum((chunk[:, None, :] - surf[None, :, :]) ** 2, axis=-1)
            depth[start : start + 256] = np.sqrt(d2.min(axis=1))
        # Subtract the probe-inflated shell (surface samples sit probe+r from
        # their parent centers) so an exposed atom's depth is ~0 regardless
        # of element — same convention as geomfeats.cpp.
        depth = np.maximum(depth - inflated, 0.0).astype(np.float32)
    else:
        depth = np.zeros(n, dtype=np.float32)
    return sasa, depth


def sasa_and_depth(coords: np.ndarray, radii: np.ndarray,
                   use_native: Optional[bool] = None):
    """Per-atom (SASA [A^2], depth-below-surface [A])."""
    if _use_native(use_native):
        return native.sasa_and_depth(coords, radii, N_SPHERE, PROBE_RADIUS)
    return _sasa_and_depth_numpy(coords, radii)


def relative_solvent_accessibility(chain: Chain, atom_sasa: np.ndarray) -> np.ndarray:
    """Residue RSA = sum of its atoms' SASA / max ASA for the residue type,
    clipped to [0, 1] (DSSP convention, consumed raw by the node schema)."""
    out = np.zeros(len(chain), dtype=np.float32)
    for i in range(len(chain)):
        s = chain.residue_atoms(i)
        asa = float(atom_sasa[s.start : s.stop].sum())
        out[i] = min(asa / MAX_ASA.get(chain.resnames[i], DEFAULT_MAX_ASA), 1.0)
    return out


def residue_depth(chain: Chain, atom_depth: np.ndarray) -> np.ndarray:
    """Residue depth = mean of its atoms' depths (Biopython/MSMS convention)."""
    out = np.zeros(len(chain), dtype=np.float32)
    for i in range(len(chain)):
        s = chain.residue_atoms(i)
        out[i] = float(atom_depth[s.start : s.stop].mean()) if s.stop > s.start else 0.0
    return out


# ---------------------------------------------------------------------------
# Protrusion index (PSAIA CX equivalent)
# ---------------------------------------------------------------------------

def _protrusion_cx_numpy(coords: np.ndarray, radius: float = CX_SPHERE_RADIUS,
                         atom_volume: float = CX_ATOM_VOLUME) -> np.ndarray:
    sq = np.sum((coords[:, None, :] - coords[None, :, :]) ** 2, axis=-1)
    count = np.sum(sq <= radius * radius, axis=1).astype(np.float32)
    v_sphere = 4.0 / 3.0 * np.pi * radius ** 3
    v_int = count * atom_volume
    v_ext = np.maximum(v_sphere - v_int, 0.0)
    return np.where(v_int > 0, v_ext / v_int, 0.0).astype(np.float32)


def protrusion_stats(chain: Chain, use_native: Optional[bool] = None) -> np.ndarray:
    """[R, 6] PSAIA table columns per residue: average CX, CX standard
    deviation, side-chain average CX, side-chain CX standard deviation, max
    CX, min CX (PSAIA_COLUMNS order, deepinteract_constants.py:37; parsed
    from ``.tbl`` files at dips_plus_utils.py:247-272). Consumed min-max
    normalized per chain/column, so the shared scale is what matters."""
    if _use_native(use_native):
        cx = native.protrusion_cx(chain.coords, CX_SPHERE_RADIUS, CX_ATOM_VOLUME)
    else:
        cx = _protrusion_cx_numpy(chain.coords)
    side = chain.side_chain_slices()
    out = np.zeros((len(chain), 6), dtype=np.float32)
    for i in range(len(chain)):
        s = chain.residue_atoms(i)
        vals = cx[s.start : s.stop]
        if vals.size == 0:
            continue
        sc = cx[side[i]] if side[i].size else vals
        out[i] = [vals.mean(), vals.std(), sc.mean(), sc.std(), vals.max(), vals.min()]
    return out


# ---------------------------------------------------------------------------
# Similarity matrix, CN, HSAAC (PAIRpred semantics)
# ---------------------------------------------------------------------------

def _min_dist_matrix_numpy(coords: np.ndarray, res_start: np.ndarray) -> np.ndarray:
    n_res = res_start.shape[0] - 1
    d = np.sqrt(
        np.maximum(np.sum((coords[:, None, :] - coords[None, :, :]) ** 2, axis=-1), 0.0)
    )
    out = np.minimum.reduceat(d, res_start[:-1], axis=0)
    out = np.minimum.reduceat(out, res_start[:-1], axis=1)
    assert out.shape == (n_res, n_res)
    return out.astype(np.float32)


def min_dist_matrix(chain: Chain, use_native: Optional[bool] = None) -> np.ndarray:
    """[R, R] minimum heavy-atom distance between residue pairs (the
    distance the PAIRpred similarity matrix is built from,
    dips_plus_utils.py:84-115)."""
    if _use_native(use_native):
        return native.min_dist_matrix(chain.coords, chain.atom_start)
    return _min_dist_matrix_numpy(chain.coords, chain.atom_start)


def similarity_matrix(min_dists: np.ndarray, sg: float = 2.0, thr: float = 1e-3):
    """(close_mask [R, R] bool incl. self, coordination numbers [R]).
    Similarity s = exp(-d^2 / (2 sg^2)); close iff s > thr
    (dips_plus_utils.py:84-115; CN counts the self entry, as the reference's
    j-from-i loop does)."""
    sim = np.exp(-(min_dists.astype(np.float64) ** 2) / (2.0 * sg * sg))
    close = sim > thr
    cn = close.sum(axis=1).astype(np.float32)
    return close, cn


def side_chain_vectors(chain: Chain) -> np.ndarray:
    """[R, 3] mean unit vector from CA to side-chain atoms; glycine uses the
    negated mean of the unit vectors to C and N (PAIRpred
    ``get_side_chain_vector``, dips_plus_utils.py:55-81). NaN if no CA."""
    out = np.full((len(chain), 3), np.nan, dtype=np.float32)
    side = chain.side_chain_slices()
    for i in range(len(chain)):
        ca = chain.atom_coord(i, "CA")
        if ca is None:
            continue
        if side[i].size:
            dv = chain.coords[side[i]] - ca
        else:
            c, n = chain.atom_coord(i, "C"), chain.atom_coord(i, "N")
            if c is None or n is None:
                continue
            dv = -(np.stack([c, n]) - ca)
        norms = np.linalg.norm(dv, axis=1, keepdims=True)
        norms[norms == 0] = 1.0
        out[i] = (dv / norms).mean(axis=0)
    return out


def hsaac(chain: Chain, close_mask: np.ndarray) -> np.ndarray:
    """[R, 42] half-sphere amino-acid composition: up-half 21 + down-half 21
    (dips_plus_utils.py:118-161). The up direction is the side-chain vector;
    each close neighbor j is binned by the angle between that vector and
    CA_j - CA_i. Reference quirks kept: the residue's own type seeds both
    halves, the self entry of the close list lands in the down half (its
    zero-vector angle comparison is False), and columns are normalized by
    1 + (up|down) count."""
    r = len(chain)
    na = len(constants.AMINO_ACIDS)
    ca = np.stack([
        chain.atom_coord(i, "CA") if chain.atom_coord(i, "CA") is not None
        else np.zeros(3, np.float32)
        for i in range(r)
    ])
    u = side_chain_vectors(chain)
    uc = np.zeros((r, na), dtype=np.float64)
    dc = np.zeros((r, na), dtype=np.float64)
    un = np.zeros(r, dtype=np.float64)
    dn = np.zeros(r, dtype=np.float64)
    letters = [constants.D3TO1.get(rn, "-") for rn in chain.resnames]
    idxs = np.asarray([_AA_IDX[l] for l in letters])
    missing = np.any(np.isnan(u), axis=1)
    for i in range(r):
        if missing[i]:
            uc[i] = dc[i] = np.nan
            un[i] = dn[i] = np.nan
            continue
        uc[i, idxs[i]] += 1
        dc[i, idxs[i]] += 1
        for j in np.flatnonzero(close_mask[i]):
            d = ca[j] - ca[i]
            nd = np.linalg.norm(d)
            nu = np.linalg.norm(u[i])
            cos = np.dot(u[i], d) / (nu * nd) if nd * nu > 0 else np.nan
            angle = np.arccos(np.clip(cos, -1.0, 1.0)) if np.isfinite(cos) else np.nan
            if angle < np.pi / 2.0:  # NaN compares False -> down half
                un[i] += 1
                uc[i, idxs[j]] += 1
            else:
                dn[i] += 1
                dc[i, idxs[j]] += 1
    uc = uc / (1.0 + un[:, None])
    dc = dc / (1.0 + dn[:, None])
    return np.concatenate([uc, dc], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# Secondary structure (Kabsch-Sander / DSSP 8-state)
# ---------------------------------------------------------------------------

_HB_Q1Q2_F = 0.084 * 332.0  # Kabsch-Sander electrostatic H-bond constant
_HB_CUTOFF = -0.5  # kcal/mol
_CHAIN_BREAK_CA_DIST = 4.5  # A; consecutive residues farther apart are a break


def _hbond_matrix(backbone: np.ndarray, contiguous: np.ndarray) -> np.ndarray:
    """hb[d, a] = True iff the N-H of residue d donates an H-bond to the
    C=O of residue a (energy < -0.5 kcal/mol, Kabsch-Sander formula).

    The amide H is reconstructed DSSP-style: 1 A from N, anti-parallel to
    the preceding residue's C=O. Residues after a chain break (or index 0)
    have no H and cannot donate; prolines cannot donate either — but
    resname info is applied by the caller.
    """
    n_at, ca, c_at, o_at = (backbone[:, i] for i in range(4))
    r = backbone.shape[0]
    h = np.full((r, 3), np.nan, dtype=np.float32)
    co = c_at[:-1] - o_at[:-1]
    norm = np.linalg.norm(co, axis=1, keepdims=True)
    norm[norm == 0] = 1.0
    h_pos = n_at[1:] + co / norm
    h[1:] = np.where(contiguous[:, None], h_pos, np.nan)

    def dist(a, b):  # [r, r] pairwise
        return np.sqrt(
            np.maximum(np.sum((a[:, None, :] - b[None, :, :]) ** 2, axis=-1), 1e-12)
        )

    with np.errstate(invalid="ignore", divide="ignore"):
        e = _HB_Q1Q2_F * (
            1.0 / dist(n_at, o_at)
            + 1.0 / dist(h, c_at)
            - 1.0 / dist(h, o_at)
            - 1.0 / dist(n_at, c_at)
        )
    hb = e < _HB_CUTOFF
    hb &= ~np.isnan(e)
    np.fill_diagonal(hb, False)
    # No bond between sequence neighbors (|d - a| < 2 is sterically fixed).
    idx = np.arange(r)
    hb &= np.abs(idx[:, None] - idx[None, :]) >= 2
    return hb


def assign_secondary_structure(backbone: np.ndarray,
                               resnames: Optional[Sequence[str]] = None) -> List[str]:
    """8-state DSSP-style assignment per residue: H G I E B T S '-'.

    Kabsch-Sander H-bond energies over reconstructed amide hydrogens, then
    the standard pattern rules: n-turns -> helices (H=4, G=3, I=5), bridge
    patterns -> ladders (E) and isolated bridges (B), remaining turn spans
    -> T, kappa > 70 degrees bend -> S. Priority H > B/E > G > I > T > S as
    in DSSP. This replaces the external ``mkdssp`` binary the reference
    drives through Biopython (dips_plus_utils.py:215-233); assignments can
    differ from mkdssp on edge residues, which the 8-way one-hot schema and
    downstream training tolerate.
    """
    r = backbone.shape[0]
    if r == 0:
        return []
    ca = backbone[:, 1]
    contiguous = (
        np.linalg.norm(ca[1:] - ca[:-1], axis=1) <= _CHAIN_BREAK_CA_DIST
        if r > 1 else np.zeros(0, dtype=bool)
    )
    hb = _hbond_matrix(backbone, contiguous)
    if resnames is not None:  # proline has no amide H -> cannot donate
        for i, rn in enumerate(resnames):
            if rn == "PRO":
                hb[i, :] = False

    def cont_span(i: int, j: int) -> bool:
        return bool(np.all(contiguous[i:j])) if j > i else True

    # turn(n)[i]: H-bond from residue i+n back to i, within one segment.
    turn = {n: np.zeros(r, dtype=bool) for n in (3, 4, 5)}
    for n in turn:
        for i in range(r - n):
            if hb[i + n, i] and cont_span(i, i + n):
                turn[n][i] = True

    ss = np.array(["-"] * r, dtype="<U1")

    def set_span(start: int, length: int, code: str):
        for k in range(start, min(start + length, r)):
            if ss[k] == "-":
                ss[k] = code

    # Helices: two consecutive n-turns starting at i-1 and i make a minimal
    # helix at i..i+n-1. Priority by assignment order: H, then E/B (below),
    # then G, I.
    for i in range(1, r - 3):
        if turn[4][i - 1] and turn[4][i]:
            set_span(i, 4, "H")

    # Bridges: hb[d, a] = N-H(d) -> C=O(a).
    parallel = np.zeros((r, r), dtype=bool)
    antiparallel = np.zeros((r, r), dtype=bool)
    for i in range(1, r - 1):
        for j in range(i + 3, r - 1):
            if (hb[j, i - 1] and hb[i + 1, j]) or (hb[i, j - 1] and hb[j + 1, i]):
                parallel[i, j] = parallel[j, i] = True
            if (hb[j, i] and hb[i, j]) or (hb[j + 1, i - 1] and hb[i + 1, j - 1]):
                antiparallel[i, j] = antiparallel[j, i] = True
    bridge = parallel | antiparallel
    in_bridge = bridge.any(axis=1)
    # Ladder: adjacent residues both bridged -> E; isolated bridge -> B.
    for i in range(r):
        if not in_bridge[i] or ss[i] != "-":
            continue
        neighbor_in_ladder = (
            (i > 0 and in_bridge[i - 1] and contiguous[i - 1])
            or (i < r - 1 and in_bridge[i + 1] and (i < len(contiguous) and contiguous[i]))
        )
        ss[i] = "E" if neighbor_in_ladder else "B"

    for i in range(1, r - 2):
        if turn[3][i - 1] and turn[3][i]:
            set_span(i, 3, "G")
    for i in range(1, r - 4):
        if turn[5][i - 1] and turn[5][i]:
            set_span(i, 5, "I")

    # T: inside any single n-turn span, not already assigned.
    for n in (3, 4, 5):
        for i in range(r - n):
            if turn[n][i]:
                for k in range(i + 1, i + n):
                    if ss[k] == "-":
                        ss[k] = "T"

    # S: bend, kappa(CA[i-2], CA[i], CA[i+2]) > 70 degrees.
    for i in range(2, r - 2):
        if ss[i] != "-" or not cont_span(i - 2, i + 2):
            continue
        v1 = ca[i] - ca[i - 2]
        v2 = ca[i + 2] - ca[i]
        denom = np.linalg.norm(v1) * np.linalg.norm(v2)
        if denom == 0:
            continue
        kappa = np.degrees(np.arccos(np.clip(np.dot(v1, v2) / denom, -1.0, 1.0)))
        if kappa > 70.0:
            ss[i] = "S"

    return ss.tolist()


def ss_one_hot(ss: Sequence[str]) -> np.ndarray:
    """[R, 8] one-hot over ALLOWABLE_SS; unknown maps to the last bin '-'
    (one_of_k_encoding_unk semantics, graph_utils.py:114-126)."""
    out = np.zeros((len(ss), len(constants.ALLOWABLE_SS)), dtype=np.float32)
    for i, s in enumerate(ss):
        j = constants.ALLOWABLE_SS.index(s) if s in constants.ALLOWABLE_SS else len(constants.ALLOWABLE_SS) - 1
        out[i, j] = 1.0
    return out


def resname_one_hot(resnames: Sequence[str]) -> np.ndarray:
    """[R, 20] one-hot over ALLOWABLE_RESNAMES; unknown residues map to the
    last entry (GLN) exactly like ``one_of_k_encoding_unk``."""
    out = np.zeros((len(resnames), len(constants.ALLOWABLE_RESNAMES)), dtype=np.float32)
    for i, rn in enumerate(resnames):
        j = (constants.ALLOWABLE_RESNAMES.index(rn)
             if rn in constants.ALLOWABLE_RESNAMES
             else len(constants.ALLOWABLE_RESNAMES) - 1)
        out[i, j] = 1.0
    return out
