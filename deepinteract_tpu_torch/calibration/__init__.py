"""Probability calibration for contact predictions.

Port of ``deepinteract_tpu/calibration/`` (numpy, float64): the same fits
to 1e-6 on the same inputs, and the same artifact files, so either
package loads the other's calibration.

The decoder emits ``softmax(logits)[..., 1]`` — raw positive-class
probabilities. Downstream ranking (screening, assembly interface
graphs, canary agreement) treats those numbers as *probabilities*, so
they must be calibrated: a pool of contacts predicted at 0.8 should be
real ~80% of the time. This package fits and applies the standard
post-hoc maps — temperature scaling (Guo et al. 2017; one scalar on the
recovered logit) and isotonic regression (PAV) — and persists the
fitted map as a durable artifact keyed by the engine's
``weights_signature`` so a calibration fitted for one checkpoint can
never silently rescale another's outputs.
"""

from deepinteract_tpu_torch.calibration.calibrator import (
    CALIBRATION_KIND,
    CALIBRATION_SCHEMA,
    Calibrator,
    expected_calibration_error,
    fit_isotonic,
    fit_temperature,
    load_calibration,
    logits_to_probs,
    miscalibrated_labels,
    nll,
    probs_to_logits,
    save_calibration,
)

__all__ = [
    "CALIBRATION_KIND",
    "CALIBRATION_SCHEMA",
    "Calibrator",
    "expected_calibration_error",
    "fit_isotonic",
    "fit_temperature",
    "load_calibration",
    "logits_to_probs",
    "miscalibrated_labels",
    "nll",
    "probs_to_logits",
    "save_calibration",
]
