"""The port's training supervisor (``training/supervisor.py``) and
``cli.train --supervise``. The watchdog runs against stub children that
write their own heartbeat: a hung child stamps its progress an hour in
the past and freezes, so the hang verdict holds however slow the machine
is, and no test waits for a timeout. Covered: crash -> resume, hang ->
kill -> resume, the circuit breaker, SIGTERM forwarded and drained, the
fault plan stripped from a restarted child, the ``train_supervise/v1``
record against ``tools/check_cli_contract.py``, and one real CPU
``cli.train --supervise`` run crashed mid-epoch by the fault plan that
ends bitwise equal to the uninterrupted run."""

import json
import os
import subprocess
import sys

import pytest

from deepinteract_tpu_torch.training.checkpoint import CheckpointConfig, Checkpointer
from deepinteract_tpu_torch.training.supervisor import (SuperviseConfig, TrainingSupervisor,
                                                        strip_supervisor_flags,
                                                        train_child_cmd_fn)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
from check_cli_contract import check_cli_contract_text  # noqa: E402

# A stand-in for cli.train: python stub.py MODE HEARTBEAT LOG [--resume].
STUB = r'''
import json, os, signal, socket, sys, time
mode, hb_path, log_path = sys.argv[1:4]
resume = "--resume" in sys.argv

def log(**record):
    with open(log_path, "a") as f:
        f.write(json.dumps(record) + "\n")

def beat(last_progress):
    tmp = hb_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"host": f"{socket.gethostname()}:{os.getpid()}", "step": 3, "epoch": 0,
                   "written_ts": time.time(), "last_progress_ts": last_progress}, f)
    os.replace(tmp, hb_path)

log(pid=os.getpid(), resume=resume, faults=os.environ.get("DI_FAULTS"))
if mode == "hang" and not resume:
    while True:  # a live beat whose progress stamp is an hour old
        beat(time.time() - 3600)
        time.sleep(0.05)
if mode == "term":
    def drain(signum, frame):
        log(drained=True)
        sys.exit(0)
    signal.signal(signal.SIGTERM, drain)
    os.kill(os.getppid(), signal.SIGTERM)  # the preemption reaches the supervisor
    while True:
        time.sleep(0.05)
if mode == "flap" or (mode == "crash" and not resume):
    sys.exit(1)
sys.exit(0)
'''


def _supervisor(tmp_path, mode, **cfg):
    stub = tmp_path / "stub.py"
    stub.write_text(STUB)
    hb, log = tmp_path / "hb.json", tmp_path / "log.jsonl"

    def cmd_fn(resume, attempt):
        return [sys.executable, str(stub), mode, str(hb), str(log)] + (
            ["--resume"] if resume else [])

    config = SuperviseConfig(heartbeat_path=str(hb), state_dir=str(tmp_path / "state"),
                             heartbeat_seconds=5.0, poll_interval_s=0.02,
                             hang_timeout_s=60.0, start_grace_s=600.0, restart_backoff_s=0.0,
                             **cfg)
    env = dict(os.environ, DI_FAULTS="training.hang=@2")
    return TrainingSupervisor(cmd_fn, config, env=env, log=lambda s: None), log


def _incarnations(log):
    return [json.loads(line) for line in log.read_text().splitlines()]


@pytest.mark.parametrize("mode", ["crash", "hang"])
def test_crash_or_hang_restarts_once_into_resume(tmp_path, mode):
    sup, log = _supervisor(tmp_path, mode)
    assert sup.run() == 0
    runs = _incarnations(log)
    assert [r["resume"] for r in runs] == [False, True]
    record = sup.contract()
    assert (record["restarts"], record["hang_kills"], record["crashes"], record["spawns"],
            record["ok"], record["child_exit_code"]) == (
                1, int(mode == "hang"), int(mode == "crash"), 2, True, 0)
    # The fault plan describes the first incarnation only.
    assert [r["faults"] for r in runs] == ["training.hang=@2", None]
    state = json.loads((tmp_path / "state" / "train_supervisor_state.json").read_text())
    assert state["state"] == "finished" and state["restarts"] == 1
    check_cli_contract_text(json.dumps(record), "train_supervise")


def test_circuit_breaker_opens_on_a_crash_loop(tmp_path):
    sup, log = _supervisor(tmp_path, "flap", circuit_max_restarts=3)
    assert sup.run() == 3
    record = sup.contract()
    assert record["circuit_open"] and not record["ok"] and record["state"] == "circuit_open"
    assert len(_incarnations(log)) == 3 and record["restarts"] == 2


def test_sigterm_is_forwarded_and_drained(tmp_path):
    """The supervisor runs in its own process; the stub sends it SIGTERM
    and exits 0 once the forwarded signal arrives."""
    stub = tmp_path / "stub.py"
    stub.write_text(STUB)
    code = (
        "import json, sys\n"
        "from deepinteract_tpu_torch.training.supervisor import SuperviseConfig, "
        "TrainingSupervisor\n"
        f"cmd = [sys.executable, {str(stub)!r}, 'term', {str(tmp_path / 'hb.json')!r}, "
        f"{str(tmp_path / 'log.jsonl')!r}]\n"
        f"cfg = SuperviseConfig(heartbeat_path={str(tmp_path / 'hb.json')!r}, "
        f"state_dir={str(tmp_path)!r}, poll_interval_s=0.02, start_grace_s=600.0)\n"
        "sup = TrainingSupervisor(lambda resume, attempt: cmd, cfg, log=lambda s: None)\n"
        "rc = sup.run()\n"
        "print(json.dumps(sup.contract()))\n"
        "sys.exit(rc)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    record = check_cli_contract_text(proc.stdout, "train_supervise")
    assert record["preempted"] and record["ok"] and record["restarts"] == 0
    assert {"drained": True} in _incarnations(tmp_path / "log.jsonl")


def test_child_command_strips_the_supervisor_flags():
    argv = ["--dips_root", "d", "--supervise", "--hang_timeout_s", "30",
            "--watch_interval_s=2", "--train_circuit_max_restarts", "2", "--num_epochs", "3"]
    child = strip_supervisor_flags(argv)
    assert child == ["--dips_root", "d", "--num_epochs", "3"]
    cmd = train_child_cmd_fn(child, 5.0)(True, 1)
    assert cmd[1:3] == ["-m", "deepinteract_tpu_torch.cli.train"]
    assert cmd[-3:] == ["--heartbeat_seconds", "5.0", "--resume"]


TINY = ["--num_gnn_hidden_channels", "16", "--num_gnn_attention_heads", "2",
        "--num_interact_layers", "2", "--num_interact_hidden_channels", "16",
        "--log_every", "0", "--device", "cpu", "--num_epochs", "1", "--save_every_steps", "1"]


def _train(root, ckpt_dir, *extra, faults=None):
    env = {k: v for k, v in os.environ.items() if k not in ("DI_FAULTS", "PYTHONPATH")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    if faults:
        env["DI_FAULTS"] = faults
    return subprocess.run([sys.executable, "-m", "deepinteract_tpu_torch.cli.train",
                           "--dips_root", str(root), "--ckpt_dir", str(ckpt_dir), *TINY,
                           *extra], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)


def test_supervised_cli_train_crashed_mid_epoch_ends_bitwise_equal(tmp_path):
    from deepinteract_tpu_torch.data.synthetic import write_tiny_npz_dataset
    import torch

    write_tiny_npz_dataset(str(tmp_path / "dips"), n_complexes=3)
    whole = _train(tmp_path / "dips", tmp_path / "whole")
    assert whole.returncode == 0, whole.stderr
    sup = _train(tmp_path / "dips", tmp_path / "sup", "--supervise",
                 "--train_restart_backoff_s", "0", "--watch_interval_s", "0.05",
                 faults="training.step_crash=@2")
    assert sup.returncode == 0, sup.stderr
    assert "injected training.step_crash" in sup.stderr
    record = check_cli_contract_text(sup.stdout, "train_supervise")
    assert (record["restarts"], record["crashes"], record["hang_kills"]) == (1, 1, 0)
    # The child's last line (test metrics) precedes the record, as unsupervised.
    assert sup.stdout.splitlines()[-2] == whole.stdout.splitlines()[-1]
    a = Checkpointer(CheckpointConfig(directory=str(tmp_path / "whole"))).restore(which="last")
    b = Checkpointer(CheckpointConfig(directory=str(tmp_path / "sup"))).restore(which="last")
    flat_a, flat_b = _flatten(a), _flatten(b)
    assert flat_a.keys() == flat_b.keys()
    for key, value in flat_a.items():
        assert (torch.equal(value, flat_b[key]) if isinstance(value, torch.Tensor)
                else value == flat_b[key]), key


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, prefix + (i,)))
        return out
    return {prefix: tree}


def test_retry_backoff_and_the_restart_counter():
    """``compute_delay``'s jittered exponential backoff, ``retry``
    re-raising the original error once its attempts are spent, and the
    supervisor's restart counter in the Prometheus exposition."""
    import random

    from deepinteract_tpu_torch.obs import metrics
    from deepinteract_tpu_torch.robustness.retry import compute_delay, retry

    rng = random.Random(0)
    for attempt in range(8):
        delay = compute_delay(attempt, 0.5, 4.0, rng)
        cap = min(4.0, 0.5 * 2 ** attempt)
        assert cap / 2 <= delay <= cap
    calls, sleeps = [], []

    @retry(exceptions=(OSError,), max_attempts=3, base_delay=0.1, sleep=sleeps.append,
           rng=rng, label="test_site")
    def flaky():
        calls.append(1)
        raise OSError(f"attempt {len(calls)}")

    with pytest.raises(OSError, match="attempt 3"):
        flaky()
    assert len(calls) == 3 and len(sleeps) == 2
    assert metrics.counter("di_retry_attempts_total", labelnames=("site",)).value(
        site="test_site") == 2
    restarts = metrics.counter("di_train_supervisor_restarts_total", labelnames=("cause",))
    before = restarts.value(cause="crash")
    restarts.inc(cause="crash")
    text = metrics.render()
    assert "# TYPE di_train_supervisor_restarts_total counter" in text
    assert f'di_train_supervisor_restarts_total{{cause="crash"}} {int(before + 1)}' in text
