"""Fit/apply/persist post-hoc probability calibration maps.

Port of ``deepinteract_tpu/calibration/calibrator.py``.

Numerics note: the serving decoder returns probabilities (the engine
applies ``softmax`` on device), so temperature scaling here operates on
the RECOVERED binary logit ``z = log(p / (1 - p))`` — for a two-class
softmax that difference IS the logit temperature scaling divides, so
``sigmoid(z / T)`` is exactly the paper's map without re-plumbing raw
logits through the decode graphs. Probabilities are clipped to
``[1e-7, 1 - 1e-7]`` before the log so saturated pixels stay finite.

Everything is plain numpy (float64): fitting runs on a few thousand
held-out contacts, far below the threshold where the device would help,
and a calibration artifact must reproduce bit-identically on any host.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from deepinteract_tpu_torch.robustness import artifacts

CALIBRATION_KIND = "calibration"       # sidecar kind (the JAX fsck dispatches on it)
CALIBRATION_SCHEMA = "calibration/v1"  # payload schema
_EPS = 1e-7


def probs_to_logits(probs: np.ndarray) -> np.ndarray:
    """Binary logit recovered from a positive-class probability map."""
    p = np.clip(np.asarray(probs, dtype=np.float64), _EPS, 1.0 - _EPS)
    return np.log(p) - np.log1p(-p)


def logits_to_probs(logits: np.ndarray) -> np.ndarray:
    z = np.asarray(logits, dtype=np.float64)
    # Stable sigmoid: exp only ever sees non-positive arguments.
    out = np.empty_like(z)
    pos = z >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-z[pos]))
    ez = np.exp(z[~pos])
    out[~pos] = ez / (1.0 + ez)
    return out


def nll(probs: np.ndarray, labels: np.ndarray) -> float:
    """Mean binary cross-entropy of ``probs`` against 0/1 ``labels`` —
    the proper scoring rule temperature fitting minimizes."""
    p = np.clip(np.asarray(probs, dtype=np.float64).ravel(), _EPS,
                1.0 - _EPS)
    y = np.asarray(labels, dtype=np.float64).ravel()
    if p.shape != y.shape:
        raise ValueError(f"probs/labels shape mismatch: {p.shape} vs "
                         f"{y.shape}")
    return float(-np.mean(y * np.log(p) + (1.0 - y) * np.log1p(-p)))


def fit_temperature(probs: np.ndarray, labels: np.ndarray,
                    lo: float = 0.05, hi: float = 20.0,
                    iters: int = 80) -> float:
    """The NLL-minimizing temperature on held-out (probs, labels).

    One scalar, one convex-ish 1-D objective: a coarse log-space grid
    locates the basin, golden-section refines it — deterministic, no
    optimizer dependency, microseconds of work.
    """
    z = probs_to_logits(probs).ravel()
    y = np.asarray(labels, dtype=np.float64).ravel()
    if z.size == 0:
        raise ValueError("cannot fit a temperature on zero contacts")

    def loss(log_t: float) -> float:
        return nll(logits_to_probs(z / np.exp(log_t)), y)

    grid = np.linspace(np.log(lo), np.log(hi), 41)
    losses = [loss(g) for g in grid]
    i = int(np.argmin(losses))
    a = grid[max(0, i - 1)]
    b = grid[min(len(grid) - 1, i + 1)]
    # Golden-section on [a, b].
    gr = (np.sqrt(5.0) - 1.0) / 2.0
    c, d = b - gr * (b - a), a + gr * (b - a)
    fc, fd = loss(c), loss(d)
    for _ in range(iters):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - gr * (b - a)
            fc = loss(c)
        else:
            a, c, fc = c, d, fd
            d = a + gr * (b - a)
            fd = loss(d)
    return float(np.exp((a + b) / 2.0))


def fit_isotonic(probs: np.ndarray, labels: np.ndarray,
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Pool-adjacent-violators isotonic fit; returns the step map as
    ``(x, y)`` knots for ``np.interp`` (x = per-block mean input
    probability, y = fitted non-decreasing label rate)."""
    p = np.asarray(probs, dtype=np.float64).ravel()
    y = np.asarray(labels, dtype=np.float64).ravel()
    if p.size == 0:
        raise ValueError("cannot fit isotonic regression on zero contacts")
    order = np.argsort(p, kind="stable")
    p, y = p[order], y[order]
    # Blocks as (value_sum, weight, x_sum); merge while decreasing.
    vals: list = []
    for xi, yi in zip(p, y):
        vals.append([yi, 1.0, xi])
        while len(vals) > 1 and (vals[-2][0] / vals[-2][1]
                                 > vals[-1][0] / vals[-1][1]):
            b = vals.pop()
            vals[-1][0] += b[0]
            vals[-1][1] += b[1]
            vals[-1][2] += b[2]
    xs = np.array([b[2] / b[1] for b in vals])
    ys = np.array([b[0] / b[1] for b in vals])
    return xs, ys


def expected_calibration_error(probs: np.ndarray, labels: np.ndarray,
                               bins: int = 15) -> float:
    """ECE with equal-width confidence bins: the bin-weighted mean gap
    between predicted confidence and observed label rate."""
    p = np.asarray(probs, dtype=np.float64).ravel()
    y = np.asarray(labels, dtype=np.float64).ravel()
    if p.shape != y.shape:
        raise ValueError(f"probs/labels shape mismatch: {p.shape} vs "
                         f"{y.shape}")
    if p.size == 0:
        return 0.0
    edges = np.linspace(0.0, 1.0, bins + 1)
    idx = np.clip(np.digitize(p, edges[1:-1]), 0, bins - 1)
    ece = 0.0
    for b in range(bins):
        mask = idx == b
        n = int(mask.sum())
        if n == 0:
            continue
        ece += (n / p.size) * abs(float(p[mask].mean())
                                  - float(y[mask].mean()))
    return float(ece)


def miscalibrated_labels(probs: np.ndarray, true_temperature: float = 2.5,
                         seed: int = 0) -> np.ndarray:
    """Deterministic synthetic labels whose TRUE contact rate is the
    model's probability at ``true_temperature`` — i.e. the model is
    overconfident by exactly that factor. The CPU-rehearsal fixture for
    cli/calibrate.py --synthetic_chains and the ECE-improves tests: a
    temperature fit on these labels should recover ~true_temperature
    and measurably shrink ECE."""
    p_true = logits_to_probs(probs_to_logits(probs) / true_temperature)
    rng = np.random.default_rng(seed)
    return (rng.random(p_true.shape) < p_true).astype(np.float64)


@dataclasses.dataclass(frozen=True)
class Calibrator:
    """A fitted probability map plus the identity it is valid for."""

    method: str = "temperature"  # "temperature" | "isotonic" | "identity"
    temperature: float = 1.0
    iso_x: Tuple[float, ...] = ()
    iso_y: Tuple[float, ...] = ()
    weights_signature: str = ""

    def __post_init__(self):
        if self.method not in ("temperature", "isotonic", "identity"):
            raise ValueError(f"unknown calibration method {self.method!r}")
        if self.method == "temperature" and not self.temperature > 0:
            raise ValueError(f"temperature must be > 0, got "
                             f"{self.temperature!r}")
        if self.method == "isotonic" and (
                len(self.iso_x) == 0 or len(self.iso_x) != len(self.iso_y)):
            raise ValueError("isotonic calibrator needs matching non-empty "
                             "iso_x/iso_y knots")

    def apply(self, probs: np.ndarray) -> np.ndarray:
        """Calibrated probabilities, same shape as the input; the input
        (the raw map) is never modified — callers keep both."""
        p = np.asarray(probs, dtype=np.float64)
        if self.method == "temperature":
            return logits_to_probs(probs_to_logits(p) / self.temperature)
        if self.method == "isotonic":
            flat = np.interp(p.ravel(), np.asarray(self.iso_x),
                             np.asarray(self.iso_y))
            return np.clip(flat, 0.0, 1.0).reshape(p.shape)
        return p.copy()

    def to_json(self) -> Dict:
        return {
            "schema": CALIBRATION_SCHEMA,
            "method": self.method,
            "temperature": self.temperature,
            "iso_x": list(self.iso_x),
            "iso_y": list(self.iso_y),
            "weights_signature": self.weights_signature,
        }

    @classmethod
    def from_json(cls, payload: Dict) -> "Calibrator":
        if not isinstance(payload, dict):
            raise ValueError("calibration payload is not an object")
        schema = payload.get("schema")
        if schema != CALIBRATION_SCHEMA:
            raise ValueError(f"calibration schema {schema!r} != "
                             f"{CALIBRATION_SCHEMA}")
        return cls(
            method=str(payload.get("method", "temperature")),
            temperature=float(payload.get("temperature", 1.0)),
            iso_x=tuple(float(x) for x in payload.get("iso_x", ())),
            iso_y=tuple(float(x) for x in payload.get("iso_y", ())),
            weights_signature=str(payload.get("weights_signature", "")),
        )


def fit_calibrator(probs: np.ndarray, labels: np.ndarray,
                   method: str = "temperature",
                   weights_signature: str = "") -> Calibrator:
    """Fit the requested map on held-out (probs, labels)."""
    if method == "temperature":
        return Calibrator(method="temperature",
                          temperature=fit_temperature(probs, labels),
                          weights_signature=weights_signature)
    if method == "isotonic":
        xs, ys = fit_isotonic(probs, labels)
        return Calibrator(method="isotonic",
                          iso_x=tuple(float(x) for x in xs),
                          iso_y=tuple(float(y) for y in ys),
                          weights_signature=weights_signature)
    raise ValueError(f"unknown calibration method {method!r} "
                     "(want temperature|isotonic)")


def save_calibration(path: str, cal: Calibrator,
                     extra: Optional[Dict] = None) -> None:
    """Persist as a durable artifact: atomic write + sha256 sidecar,
    with the weights_signature mirrored into the sidecar's ``extra`` so
    verification can refuse a stale map WITHOUT trusting the payload."""
    side = {"weights_signature": cal.weights_signature,
            "method": cal.method}
    if extra:
        side.update(extra)
    artifacts.atomic_write_artifact(
        path, json.dumps(cal.to_json(), sort_keys=True),
        kind=CALIBRATION_KIND, extra=side)


def load_calibration(path: str, expect_signature: Optional[str] = None,
                     allow_stale: bool = False) -> Calibrator:
    """Verified load. ``expect_signature`` (the consuming engine's
    ``weights_signature()``) turns a mismatch into a typed
    :class:`~deepinteract_tpu_torch.robustness.artifacts.StaleArtifact`;
    ``allow_stale`` skips only the signature check, never integrity."""
    expect = None
    if expect_signature is not None and not allow_stale:
        expect = {"weights_signature": expect_signature}
    payload = artifacts.verify_json(path, CALIBRATION_KIND, expect=expect)
    try:
        return Calibrator.from_json(payload)
    except ValueError as exc:
        raise artifacts.CorruptArtifact(path, str(exc))


def annotate_records(records: Sequence[Dict], cal: Optional[Calibrator],
                     ) -> None:
    """Add ``calibrated_score`` (and per-contact ``p_cal``) next to the
    raw fields of screening/query-style pair records, in place. Raw
    ``score``/``p`` stay byte-identical — the parity contract across
    screen/funnel/assembly is on the raw values."""
    if cal is None:
        return
    for rec in records:
        ps = [c["p"] for c in rec.get("top_contacts", ()) if "p" in c]
        for contact in rec.get("top_contacts", ()):
            if "p" in contact:
                contact["p_cal"] = round(
                    float(cal.apply(np.asarray(contact["p"]))), 6)
        if "score" in rec:
            # Monotone maps preserve the top-k set, so the mean of the
            # calibrated top-k probabilities IS pair_summary's score
            # computed on the calibrated map (up to the records' 6-dp
            # contact rounding).
            if ps:
                rec["calibrated_score"] = float(
                    np.mean(cal.apply(np.asarray(ps))))
            else:
                rec["calibrated_score"] = float(
                    cal.apply(np.asarray(rec["score"])))
