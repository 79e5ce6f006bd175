"""Supervised training: spawn, watch and restart the train loop.

Port of ``deepinteract_tpu/training/supervisor.py`` for the port's
``cli.train``. ``cli.train --supervise`` runs its own command line as a
child process and:

* **spawns** the child (``python -m deepinteract_tpu_torch.cli.train``)
  with ``--heartbeat_seconds`` forced on (argparse takes the last
  occurrence), so its liveness is observable from the first poll;
* **watches** it: a poll loop checks that the process lives and reads its
  heartbeat (:func:`deepinteract_tpu_torch.obs.heartbeat.read_heartbeat`).
  The beat thread is a daemon that keeps the file fresh even when the
  step loop is stuck, so the hang signal is the staleness of
  ``last_progress_ts`` (``hang_timeout_s``), which the loop stamps on
  every train step, eval batch and checkpoint. A live child whose stamp
  stops advancing (past the per-spawn ``start_grace_s`` until it has
  trained a step) is killed with SIGKILL into the restart path; so is one
  whose heartbeat file goes stale or never appears past the grace;
* **restarts** a crashed or killed child with jittered exponential
  backoff (:func:`deepinteract_tpu_torch.robustness.retry.compute_delay`)
  into ``--resume``, which is exact mid-epoch with ``--save_every_steps``.
  The fault plan (``DI_FAULTS``) is stripped from a restarted child's
  environment: a plan describes one incarnation's faults;
* **opens a circuit breaker** after ``circuit_max_restarts`` restarts
  inside ``circuit_window_s``: it stops, reports ``circuit_open`` and
  exits nonzero, so a poisoned run does not crash-loop forever;
* **forwards SIGTERM** (and SIGINT) to the child, whose preemption guard
  flushes the newest checkpoint and exits 0, and stops supervising.

Child exit 0 is supervisor exit 0. ``cli.train`` prints
:meth:`TrainingSupervisor.contract`, the ``train_supervise/v1`` record
(``tools/check_cli_contract.py``), as the last stdout line. Every
transition is written atomically to
``<state_dir>/train_supervisor_state.json``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import signal
import subprocess
import sys
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from deepinteract_tpu_torch.obs import metrics as obs_metrics
from deepinteract_tpu_torch.obs.heartbeat import HeartbeatStatus, read_heartbeat
from deepinteract_tpu_torch.robustness import artifacts
from deepinteract_tpu_torch.robustness.retry import compute_delay

logger = logging.getLogger(__name__)

_RESTARTS = obs_metrics.counter(
    "di_train_supervisor_restarts_total",
    "Training children respawned by the supervisor", labelnames=("cause",))
_HANG_KILLS = obs_metrics.counter(
    "di_train_supervisor_hang_kills_total",
    "Live-but-hung training children (stale heartbeat progress) "
    "SIGKILLed for restart")
_CIRCUIT_OPEN = obs_metrics.gauge(
    "di_train_supervisor_circuit_open",
    "1 while the training restart circuit breaker is open")

STATE_BASENAME = "train_supervisor_state.json"

# Supervisor-only flags (cli/args.py "supervision" group): stripped from
# the child command line, which is a plain cli.train.
# (flag, takes_value).
SUPERVISOR_FLAGS = (
    ("--supervise", False),
    ("--watch_interval_s", True),
    ("--hang_timeout_s", True),
    ("--start_grace_s", True),
    ("--train_restart_backoff_s", True),
    ("--train_circuit_max_restarts", True),
    ("--train_circuit_window_s", True),
)

# Child command factory: (resume, attempt) -> argv. cli/train.py builds
# the real one; tests inject stubs.
CmdFn = Callable[[bool, int], List[str]]


def strip_supervisor_flags(argv: List[str]) -> List[str]:
    """The child's argv: the operator's command line minus the
    supervisor-only knobs (the child must not recurse into supervisor
    mode, and cli.train does not know the watch flags)."""
    flags = dict(SUPERVISOR_FLAGS)
    out: List[str] = []
    skip_value = False
    for tok in argv:
        if skip_value:
            skip_value = False
            continue
        name, eq, _val = tok.partition("=")
        if name in flags:
            skip_value = flags[name] and not eq
            continue
        out.append(tok)
    return out


def train_child_cmd_fn(child_argv: List[str],
                       heartbeat_seconds: float) -> CmdFn:
    """The real cli.train child factory: the stripped operator argv with
    ``--heartbeat_seconds`` forced on (argparse last-occurrence-wins — a
    supervised child without a beat would be unwatchable) and
    ``--resume`` appended on every restart so the child lands on the
    newest checkpoint/cursor."""

    def cmd_fn(resume: bool, attempt: int) -> List[str]:
        cmd = [sys.executable, "-m", "deepinteract_tpu_torch.cli.train"]
        cmd += list(child_argv)
        cmd += ["--heartbeat_seconds", str(heartbeat_seconds)]
        if resume:
            cmd += ["--resume"]
        return cmd

    return cmd_fn


@dataclasses.dataclass(frozen=True)
class SuperviseConfig:
    """Watchdog policy (CLI surface: cli/args.py's supervision group)."""

    heartbeat_path: str
    state_dir: str
    # Forced onto the child (train_child_cmd_fn).
    heartbeat_seconds: float = 5.0
    poll_interval_s: float = 1.0
    # Heartbeat FILE staleness bound (beat thread died / host FS gone).
    # <= 0: derived as 6x heartbeat_seconds.
    heartbeat_max_age_s: float = 0.0
    # Progress staleness bound, the hang detector. The beat file stays
    # fresh while the step loop is stuck, so the hang signal is
    # last_progress_ts (training/loop.py stamps it on train steps, eval
    # batches and checkpoints).
    hang_timeout_s: float = 600.0
    # Per-(re)spawn grace before hang/no-heartbeat verdicts: import,
    # checkpoint restore and the kernels' build make no progress.
    start_grace_s: float = 900.0
    restart_backoff_s: float = 1.0
    restart_backoff_max_s: float = 60.0
    circuit_max_restarts: int = 5
    circuit_window_s: float = 3600.0
    # Restarted children spawn WITHOUT the DI_FAULTS plan: a fault plan
    # describes one incarnation; replaying it would re-kill every resume
    # at the same call count.
    clear_fault_plan_on_restart: bool = True
    # SIGTERM-forward drain grace before the SIGKILL fallback.
    drain_timeout_s: float = 120.0


class TrainingSupervisor:
    """Run one training child under watchdog supervision (module
    docstring). Single-threaded: one child, one poll loop."""

    def __init__(self, cmd_fn: CmdFn, cfg: SuperviseConfig,
                 env: Optional[Dict[str, str]] = None,
                 log: Callable[[str], None] = None):
        self._cmd_fn = cmd_fn
        self.cfg = cfg
        self._env = dict(env if env is not None else os.environ)
        # cli/train.py passes print (the operator's console); the default
        # keeps library use print-free.
        self._log = log or logger.warning
        self.proc: Optional[subprocess.Popen] = None
        self.restarts = 0
        self.hang_kills = 0
        self.crashes = 0
        self.spawns = 0
        self.circuit_open = False
        self.preempted = False
        self.child_exit_code: Optional[int] = None
        self.state = "idle"
        self._restart_times: deque = deque()
        self._backoff_attempt = 0
        self._spawned_at = 0.0
        self._stopping = False
        os.makedirs(cfg.state_dir, exist_ok=True)
        self.state_path = os.path.join(os.path.abspath(cfg.state_dir),
                                       STATE_BASENAME)

    # -- lifecycle ---------------------------------------------------------

    def _spawn(self, resume: bool) -> bool:
        cmd = self._cmd_fn(resume, self.spawns)
        env = dict(self._env)
        if resume and self.cfg.clear_fault_plan_on_restart:
            env.pop("DI_FAULTS", None)
        # The previous incarnation's heartbeat must not outlive it: a
        # leftover fresh-looking file would mask a child that hung
        # before its first beat.
        try:
            os.unlink(self.cfg.heartbeat_path)
        except OSError:
            pass
        try:
            # stdout/stderr are INHERITED: the training log is the
            # operator's console either way, and the supervisor's final
            # contract line prints after the child exited.
            self.proc = subprocess.Popen(cmd, env=env)
        except OSError as exc:
            self._log(f"train-supervisor: spawning the child failed: {exc}")
            self.proc = None
            return False
        self.spawns += 1
        self._spawned_at = time.monotonic()
        self.state = "running"
        self._persist()
        return True

    def _hb_max_age(self) -> float:
        if self.cfg.heartbeat_max_age_s > 0:
            return self.cfg.heartbeat_max_age_s
        return 6.0 * max(0.1, self.cfg.heartbeat_seconds)

    def _child_heartbeat(self) -> HeartbeatStatus:
        """The beat our child wrote. A beat's ``host`` is "hostname:pid",
        so a file left by an earlier incarnation (another pid) reads as
        missing, which the start grace covers, and never as the live
        child's beat. Beats without a ``host`` are taken as they are."""
        status = read_heartbeat(self.cfg.heartbeat_path, self._hb_max_age())
        host = (status.payload or {}).get("host")
        if (status.payload is not None and isinstance(host, str) and self.proc is not None
                and not host.endswith(f":{self.proc.pid}")):
            return HeartbeatStatus("missing", None, None)
        return status

    def _watch_alive(self) -> None:
        """One liveness verdict for a live child; SIGKILLs a wedged one
        (the crash path then restarts it). The per-spawn start grace
        covers the startup that makes no progress (import, restore, the
        kernels' build); once the beat carries a step or epoch the child
        has trained, and the hang verdict applies at once: a mid-epoch
        hang must not hide behind a generous grace."""
        since_spawn = time.monotonic() - self._spawned_at
        in_grace = since_spawn <= self.cfg.start_grace_s
        hb = self._child_heartbeat()
        reason = None
        if hb.status == "missing":
            if in_grace:
                return
            reason = (f"no heartbeat {since_spawn:.0f}s after spawn "
                      "(hung before the beat thread started)")
        elif hb.status == "stale":
            if in_grace:
                return
            reason = (f"heartbeat file stale ({hb.age_s:.0f}s old): beat "
                      "thread dead while the process lives")
        elif self.cfg.hang_timeout_s > 0 and hb.payload is not None:
            started = isinstance(hb.payload.get("step"), int) \
                or isinstance(hb.payload.get("epoch"), int)
            last = hb.payload.get("last_progress_ts")
            if (started or not in_grace) and isinstance(last, (int, float)):
                idle = time.time() - float(last)
                if idle > self.cfg.hang_timeout_s:
                    reason = (f"no step/eval/checkpoint progress for "
                              f"{idle:.0f}s (> hang_timeout_s="
                              f"{self.cfg.hang_timeout_s:.0f})")
        if reason is None:
            return
        self.hang_kills += 1
        _HANG_KILLS.inc()
        self.state = "hang_killing"
        self._log(f"train-supervisor: child pid {self.proc.pid} is live "
                  f"but wedged ({reason}) — SIGKILL for restart")
        self._persist()
        try:
            self.proc.kill()
        except OSError:
            pass

    def _schedule_restart(self, rc: Optional[int], cause: str) -> bool:
        """Circuit bookkeeping + backoff sleep; False = breaker open."""
        now = time.monotonic()
        self._restart_times.append(now)
        while (self._restart_times
               and now - self._restart_times[0] > self.cfg.circuit_window_s):
            self._restart_times.popleft()
        if len(self._restart_times) >= self.cfg.circuit_max_restarts:
            self.circuit_open = True
            _CIRCUIT_OPEN.set(1.0)
            self.state = "circuit_open"
            self._log(
                f"train-supervisor: {len(self._restart_times)} restarts "
                f"inside {self.cfg.circuit_window_s:.0f}s — circuit OPEN, "
                "not restarting (inspect the run, then rerun --supervise)")
            self._persist()
            return False
        delay = compute_delay(self._backoff_attempt,
                              self.cfg.restart_backoff_s,
                              self.cfg.restart_backoff_max_s)
        self._backoff_attempt += 1
        self.restarts += 1
        _RESTARTS.inc(cause=cause)
        self.state = "backoff"
        self._log(f"train-supervisor: child exited rc={rc} ({cause}); "
                  f"restarting into --resume in {delay:.1f}s "
                  f"(restart #{self.restarts})")
        self._persist()
        time.sleep(delay)
        return True

    def run(self) -> int:
        """Supervise until the child finishes cleanly, the circuit opens,
        or a forwarded SIGTERM/SIGINT drains it. Returns the honest exit
        code (preempted/finished = 0); the CLI front end prints
        :meth:`contract` as the FINAL stdout line afterwards."""
        prev_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev_handlers[sig] = signal.signal(sig, self._on_signal)
            except (ValueError, OSError):  # not the main thread
                pass
        rc: Optional[int] = None
        try:
            if not self._spawn(resume=self._initial_resume()):
                # An unspawnable command is a crash on attempt 0: give
                # the restart path (and its circuit) the decision.
                if not self._schedule_restart(None, "spawn_failure"):
                    return self._finish(2)
            while True:
                if self.proc is None:
                    if self._stopping:
                        # Preemption landed during a restart backoff (no
                        # child alive): spawning a fresh child now would
                        # ignore the drain and train past the preemption
                        # deadline. Exit 0 preempted with nothing to
                        # drain; the scheduler reruns --supervise later.
                        self.state = "preempted"
                        self._persist()
                        return self._finish(0)
                    if not self._spawn(resume=True):
                        if not self._schedule_restart(None, "spawn_failure"):
                            return self._finish(2)
                        continue
                rc = self.proc.poll()
                if rc is None:
                    if not self._stopping:
                        self._watch_alive()
                    time.sleep(self.cfg.poll_interval_s)
                    continue
                self.child_exit_code = rc
                if rc == 0:
                    self.state = "finished"
                    self.preempted = self.preempted or self._stopping
                    self._persist()
                    return self._finish(0)
                if self._stopping:
                    # The drain raced a crash; honest nonzero.
                    self.state = "crashed"
                    self._persist()
                    return self._finish(rc)
                was_hang = self.state == "hang_killing"
                if not was_hang:
                    self.crashes += 1
                cause = "hang" if was_hang else "crash"
                if not self._schedule_restart(rc, cause):
                    return self._finish(3)
                self.proc = None
        finally:
            for sig, handler in prev_handlers.items():
                try:
                    signal.signal(sig, handler)
                except (ValueError, OSError):
                    pass

    def _initial_resume(self) -> bool:
        # The first spawn honors the operator's own --resume (already in
        # the child argv); cmd_fn(resume=False) must not append another.
        return False

    def _on_signal(self, signum, frame) -> None:
        """Preemption: forward SIGTERM to the child (its preemption guard
        flushes the checkpoint and exits 0) and stop supervising. The
        poll loop sees the clean exit; a child ignoring the signal past
        drain_timeout_s is SIGKILLed by _finish."""
        self._stopping = True
        self.preempted = True
        self.state = "draining"
        self._log(f"train-supervisor: signal {signum} — forwarding "
                  "SIGTERM to the child (preemption drain)")
        self._persist()
        if self.proc is not None and self.proc.poll() is None:
            try:
                self.proc.send_signal(signal.SIGTERM)
            except OSError:
                pass

    def _finish(self, code: int) -> int:
        if self.proc is not None and self.proc.poll() is None:
            try:
                self.proc.wait(timeout=self.cfg.drain_timeout_s)
            except subprocess.TimeoutExpired:
                self._log("train-supervisor: child ignored the drain — "
                          "SIGKILL")
                try:
                    self.proc.kill()
                    self.proc.wait(timeout=5.0)
                except (OSError, subprocess.TimeoutExpired):
                    pass
            if self.child_exit_code is None:
                self.child_exit_code = self.proc.poll()
        self._persist()
        return code

    # -- reporting ---------------------------------------------------------

    def contract(self) -> Dict[str, Any]:
        """The ``train_supervise/v1`` record (kind registered in
        tools/check_cli_contract.py). ``ok`` means the run ended the way
        an unsupervised healthy run would have: child exit 0 and no open
        circuit — restarts along the way do not tarnish it (recovering
        is the point), but they are all counted here."""
        ok = self.child_exit_code == 0 and not self.circuit_open
        return {
            "schema": "train_supervise/v1",
            "metric": "train_supervised_restarts",
            "value": float(self.restarts),
            "unit": "restarts",
            "ok": bool(ok),
            "restarts": int(self.restarts),
            "hang_kills": int(self.hang_kills),
            "crashes": int(self.crashes),
            "spawns": int(self.spawns),
            "circuit_open": bool(self.circuit_open),
            "preempted": bool(self.preempted),
            "child_exit_code": self.child_exit_code,
            "state": self.state,
            "state_path": self.state_path,
            "heartbeat_path": self.cfg.heartbeat_path,
        }

    def _persist(self) -> None:
        state = {
            "updated_ts": time.time(),
            "state": self.state,
            "child_pid": (self.proc.pid if self.proc is not None
                          else None),
            "spawns": self.spawns,
            "restarts": self.restarts,
            "hang_kills": self.hang_kills,
            "crashes": self.crashes,
            "circuit_open": self.circuit_open,
            "preempted": self.preempted,
            "child_exit_code": self.child_exit_code,
            "heartbeat_path": self.cfg.heartbeat_path,
        }
        try:
            artifacts.atomic_write(self.state_path,
                                   json.dumps(state, sort_keys=True),
                                   fsync=False)
        except OSError as exc:
            # A full disk must not take supervision down.
            logger.error("train-supervisor: persisting %s failed: %s",
                         self.state_path, exc)
