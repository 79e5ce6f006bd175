"""Exponential backoff with jitter + deadline for flaky side effects.

Port of ``deepinteract_tpu/robustness/retry.py``. The training supervisor
spaces its restarts with :func:`compute_delay`; :func:`retry` wraps a
side effect that fails transiently (a shared filesystem, a compiler).
One decorator centralizes the policy:

* exponential backoff (``base_delay * 2**attempt``) capped at
  ``max_delay``, with full jitter (uniform in ``[delay/2, delay]``) so
  concurrent workers decorrelate;
* an overall ``deadline`` in seconds — a retry loop must never outlive
  the grace period of the job around it;
* a ``retryable`` predicate for exception-level triage (e.g. HTTP 4xx is
  permanent, 5xx/connection-reset is transient);
* the ORIGINAL exception is re-raised on exhaustion — callers' error
  handling and the chaos suite's "permanent failures still hard-fail
  with the original error" criterion both depend on that.

Env knobs (read at call time so tests and operators can adjust without
code changes): ``DI_RETRY_MAX_ATTEMPTS``, ``DI_RETRY_BASE_DELAY``,
``DI_RETRY_MAX_DELAY``, ``DI_RETRY_DEADLINE`` override whatever the call
site configured.
"""

from __future__ import annotations

import functools
import logging
import os
import random
import time
from typing import Callable, Optional, Tuple, Type

from deepinteract_tpu_torch.obs import metrics as obs_metrics

logger = logging.getLogger(__name__)

# One series per retry site (the decorator's label), counting FAILED
# attempts that led to another try — a sustained nonzero rate here is the
# earliest external-dependency degradation signal the process has.
_RETRY_ATTEMPTS = obs_metrics.counter(
    "di_retry_attempts_total",
    "Failed attempts that were retried, per retry-decorated site",
    labelnames=("site",))

_ENV_OVERRIDES = {
    "max_attempts": ("DI_RETRY_MAX_ATTEMPTS", int),
    "base_delay": ("DI_RETRY_BASE_DELAY", float),
    "max_delay": ("DI_RETRY_MAX_DELAY", float),
    "deadline": ("DI_RETRY_DEADLINE", float),
}


def _effective(name: str, value):
    env_name, cast = _ENV_OVERRIDES[name]
    raw = os.environ.get(env_name)
    if raw is None:
        return value
    try:
        return cast(raw)
    except ValueError:
        logger.warning("ignoring malformed %s=%r", env_name, raw)
        return value


def compute_delay(attempt: int, base_delay: float, max_delay: float,
                  rng: Optional[random.Random] = None) -> float:
    """Backoff for the given 0-based failed-attempt index, with full
    jitter in [delay/2, delay] (decorrelates concurrent retriers)."""
    delay = min(max_delay, base_delay * (2.0 ** attempt))
    r = rng.random() if rng is not None else random.random()
    return delay * (0.5 + 0.5 * r)


def retry(
    exceptions: Tuple[Type[BaseException], ...] = (Exception,),
    max_attempts: int = 3,
    base_delay: float = 0.5,
    max_delay: float = 30.0,
    deadline: Optional[float] = None,
    retryable: Optional[Callable[[BaseException], bool]] = None,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
    rng: Optional[random.Random] = None,
    label: Optional[str] = None,
) -> Callable:
    """Decorator: retry the wrapped callable on transient failures.

    ``exceptions`` gates which exception TYPES are candidates;
    ``retryable(exc)`` (optional) refines per-instance. Anything else —
    and the final failed attempt — propagates unchanged. ``sleep`` /
    ``clock`` / ``rng`` are injectable for deterministic tests.
    """

    def decorate(fn: Callable) -> Callable:
        name = label or getattr(fn, "__qualname__", repr(fn))

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            attempts = max(1, _effective("max_attempts", max_attempts))
            base = _effective("base_delay", base_delay)
            cap = _effective("max_delay", max_delay)
            limit = _effective("deadline", deadline)
            start = clock()
            for attempt in range(attempts):
                try:
                    return fn(*args, **kwargs)
                except exceptions as exc:
                    if retryable is not None and not retryable(exc):
                        raise
                    if attempt + 1 >= attempts:
                        raise
                    pause = compute_delay(attempt, base, cap, rng)
                    if limit is not None and (clock() - start) + pause > limit:
                        logger.warning(
                            "%s: retry deadline (%.1fs) exhausted after "
                            "attempt %d: %s", name, limit, attempt + 1, exc)
                        raise
                    _RETRY_ATTEMPTS.inc(site=name)
                    logger.warning(
                        "%s: attempt %d/%d failed (%s); retrying in %.2fs",
                        name, attempt + 1, attempts, exc, pause)
                    sleep(pause)
            raise AssertionError("unreachable")  # pragma: no cover

        return wrapper

    return decorate
