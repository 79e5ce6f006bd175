"""Assemble per-residue features into the 106-d DIPS-Plus schema + impute.

Port of ``deepinteract_tpu/pipeline/postprocess.py`` (the port imports nothing
of the JAX package); every function gives the same arrays on the same
input.

Reference pipeline stages replaced here (SURVEY.md §2.3):
* ``postprocess_pruned_pair`` (dips_plus_utils.py:423-683) — feature
  collection + per-chain min-max normalization of RD / protrusion / CN
  (:564-566); RSA, HSAAC and sequence profiles stay raw.
* ``impute_postprocessed_missing_feature_values`` (dips_plus_utils.py:
  847-943) — per-column NaN fill: median when a column has at most
  NUM_ALLOWABLE_NANS NaNs, zero otherwise; hard-fails if NaNs survive.
* sequence profiles (HH-suite3 emission/transition probabilities,
  deepinteract_utils.py:704-718) — the one feature that needs an external
  database; ``sequence_profile`` shells out to hhblits when configured via
  DI_HHBLITS_BIN/DI_HHBLITS_DB and otherwise returns zeros with a warning.
"""

from __future__ import annotations

import logging
import os
import shutil
import subprocess
import tempfile
from typing import Optional

import numpy as np

from deepinteract_tpu_torch import constants
from deepinteract_tpu_torch.pipeline import residue_features as rf
from deepinteract_tpu_torch.pipeline.pdb import Chain
from deepinteract_tpu_torch.robustness import faults
from deepinteract_tpu_torch.robustness.retry import retry

logger = logging.getLogger(__name__)


def min_max_normalize_columns(x: np.ndarray) -> np.ndarray:
    """Per-column [0, 1] scaling, NaN-transparent (sklearn MinMaxScaler
    semantics used at dips_plus_utils.py:198-203: NaNs are ignored during
    fit and preserved by transform). Constant columns map to 0."""
    x = np.asarray(x, dtype=np.float64)
    lo = np.nanmin(x, axis=0, keepdims=True)
    hi = np.nanmax(x, axis=0, keepdims=True)
    rng = hi - lo
    rng[rng == 0] = 1.0
    out = (x - lo) / rng
    out[:, (hi == lo)[0]] = 0.0
    return out.astype(np.float32)


def impute_columns(x: np.ndarray,
                   max_nans: int = constants.NUM_ALLOWABLE_NANS) -> np.ndarray:
    """Median-or-zero per-column NaN fill (``determine_nan_fill_value``,
    dips_plus_utils.py:830-845)."""
    x = np.array(x, dtype=np.float32, copy=True)
    for c in range(x.shape[1]):
        col = x[:, c]
        nan_mask = np.isnan(col)
        if not nan_mask.any():
            continue
        if nan_mask.sum() <= max_nans and (~nan_mask).any():
            fill = float(np.median(col[~nan_mask]))
        else:
            fill = 0.0
        col[nan_mask] = fill
    assert not np.isnan(x).any(), "NaNs survived imputation"
    return x


def sequence_profile(sequence: str) -> np.ndarray:
    """[R, 27] profile-HMM emission (20) + transition (7) probabilities.

    With ``DI_HHBLITS_BIN`` + ``DI_HHBLITS_DB`` set, runs hhblits and parses
    the resulting .hhm the way atom3's ``map_all_profile_hmms`` does
    (2^(-value/1000) decoding). Otherwise returns zeros and warns — the
    documented degraded mode for environments without the multi-GB sequence
    database (the reference has the same hard dependency,
    README.md:41-109)."""
    bin_path = os.environ.get("DI_HHBLITS_BIN")
    db_path = os.environ.get("DI_HHBLITS_DB")
    n = len(sequence)
    # shutil.which resolves bare command names via PATH *and* validates
    # executability of absolute paths, so DI_HHBLITS_BIN=hhblits works.
    resolved = shutil.which(bin_path) if bin_path else None
    if resolved and db_path:
        try:
            return _run_hhblits(sequence, resolved, db_path)
        except Exception as exc:  # pragma: no cover - needs external DB
            logger.warning("hhblits failed (%s); sequence profile set to zeros", exc)
    elif bin_path and not resolved:
        logger.warning(
            "DI_HHBLITS_BIN=%s is not an executable on PATH; 27-d "
            "sequence-profile features set to zeros", bin_path
        )
    else:
        logger.warning(
            "no hhblits binary/database configured (DI_HHBLITS_BIN/DI_HHBLITS_DB); "
            "27-d sequence-profile features set to zeros"
        )
    return np.zeros((n, constants.NUM_SEQUENCE_FEATS), dtype=np.float32)


def _hhblits_retryable(exc: BaseException) -> bool:
    """Transient vs deterministic triage: timeouts, kill-signal deaths
    (negative returncode, or the shell-style 128+N codes an OOM killer /
    scheduler produces) and I/O errors are worth another attempt; an
    hhblits that exits with an ordinary error code (bad database path,
    malformed invocation) will fail identically every time — retrying it
    3x per chain would add hours of wasted backoff to a DIPS-scale
    featurization run before the zero-fill fallback surfaces the
    misconfiguration."""
    if isinstance(exc, subprocess.TimeoutExpired):
        return True
    if isinstance(exc, subprocess.CalledProcessError):
        return exc.returncode < 0 or exc.returncode > 128
    return isinstance(exc, OSError) and not isinstance(exc, FileNotFoundError)


# HH-suite invocations fail transiently in bulk featurization — databases
# on contended shared filesystems, OOM-killed workers, stray signals — and
# one flake used to zero an entire chain's 27-d profile. Retry the whole
# attempt (fresh temp dir per try: a half-written .hhm never leaks into
# the parse); a deterministic hhblits failure fails fast (one attempt)
# and propagates to sequence_profile's documented zero-fill warning path.
@retry(
    exceptions=(subprocess.SubprocessError, OSError),
    retryable=_hhblits_retryable,
    max_attempts=3,
    base_delay=2.0,
    max_delay=60.0,
    label="hhblits.run",
)
def _run_hhblits(sequence: str, bin_path: str, db_path: str) -> np.ndarray:
    faults.maybe_raise(
        "hhblits.run",
        lambda: subprocess.CalledProcessError(137, bin_path),
    )
    with tempfile.TemporaryDirectory() as tmp:
        fasta = os.path.join(tmp, "query.fasta")
        hhm = os.path.join(tmp, "query.hhm")
        # di: allow[artifact-write] transient hhblits input inside a TemporaryDirectory
        with open(fasta, "w") as f:
            f.write(">query\n" + sequence + "\n")
        subprocess.run(
            [bin_path, "-i", fasta, "-ohhm", hhm, "-d", db_path, "-n", "2", "-cpu", "4"],
            check=True, capture_output=True, timeout=24 * 3600,
        )
        return parse_hhm(hhm, len(sequence))


def parse_hhm(path: str, n_residues: int) -> np.ndarray:
    """Parse an hhblits .hhm profile into [R, 27] probabilities
    (atom3.conservation convention: p = 2^(-v/1000), '*' -> 0).

    Layout handled (hh-suite3 hhm format): header ends at the ``HMM``
    column-name line, followed by the transition-name line and the null
    transition row; then one 3-line record per residue — emission line
    ``<aa> <idx> <20 scores> <idx>``, transition line ``<7 scores> <3
    Neff>``, blank separator — terminated by ``//``."""
    out = np.zeros((n_residues, constants.NUM_SEQUENCE_FEATS), dtype=np.float32)

    def decode(tok: str) -> float:
        return 0.0 if tok == "*" else float(2.0 ** (-int(tok) / 1000.0))

    with open(path) as f:
        lines = f.readlines()
    start = next(i for i, l in enumerate(lines) if l.startswith("HMM")) + 3
    row = 0
    i = start
    while i + 1 < len(lines) and row < n_residues:
        em = lines[i].split()[2:22]
        tr = lines[i + 1].split()[:7]
        if len(em) == 20 and len(tr) == 7:
            out[row, :20] = [decode(t) for t in em]
            out[row, 20:] = [decode(t) for t in tr]
            row += 1
        i += 3  # emission line, transition line, blank
    return out


def compute_residue_features(
    chain: Chain,
    use_native: Optional[bool] = None,
    sequence_feats: Optional[np.ndarray] = None,
) -> np.ndarray:
    """[R, 106] DIPS-Plus residue features (node-schema columns 7..113).

    Layout per constants: resname one-hot 20 | SS one-hot 8 | RSA | RD |
    protrusion 6 | HSAAC 42 | CN | sequence 27. Normalization/imputation
    follow the reference order: per-chain min-max on RD/protrusion/CN
    first, median-or-zero imputation second.
    """
    r = len(chain)
    backbone = chain.backbone()

    res_1h = rf.resname_one_hot(chain.resnames)
    ss = rf.assign_secondary_structure(backbone, chain.resnames)
    ss_1h = rf.ss_one_hot(ss)

    sasa, depth_atom = rf.sasa_and_depth(
        chain.coords, rf.atom_radii(chain.elements), use_native=use_native
    )
    rsa = rf.relative_solvent_accessibility(chain, sasa)[:, None]
    rd = min_max_normalize_columns(rf.residue_depth(chain, depth_atom)[:, None])

    protrusion = min_max_normalize_columns(
        rf.protrusion_stats(chain, use_native=use_native)
    )

    min_dists = rf.min_dist_matrix(chain, use_native=use_native)
    close, cn = rf.similarity_matrix(min_dists)
    cn = min_max_normalize_columns(cn[:, None])
    hsaac = rf.hsaac(chain, close)

    if sequence_feats is None:
        sequence_feats = sequence_profile(chain.sequence())
    assert sequence_feats.shape == (r, constants.NUM_SEQUENCE_FEATS)

    feats = np.concatenate(
        [res_1h, ss_1h, rsa, rd, protrusion, hsaac, cn, sequence_feats], axis=1
    )
    assert feats.shape == (r, constants.NUM_NODE_FEATS - 7), feats.shape
    return impute_columns(feats)


def amide_normal_vectors_for_chain(chain: Chain) -> np.ndarray:
    """[R, 3] amide-plane normals: cross(CA-CB, CB-N) from real CB atoms
    (``get_norm_vec_for_residue``, dips_plus_utils.py:356-374); residues
    without a CB (glycine) use a virtual CB from the backbone frame so the
    vector — and the downstream edge angle — stays defined everywhere."""
    from deepinteract_tpu_torch.data.features import amide_normal_vectors

    backbone = chain.backbone()
    cb = chain.cb_coords()
    virtual = amide_normal_vectors(backbone, cb=None)
    missing = np.any(np.isnan(cb), axis=1)
    real = amide_normal_vectors(backbone, cb=np.nan_to_num(cb, nan=0.0))
    return np.where(missing[:, None], virtual, real).astype(np.float32)
