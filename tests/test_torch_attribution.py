"""The port's device-time attribution (``deepinteract_tpu_torch.obs.{device,
attribution,kernelquery}``, ``cli/attribute.py`` and the trainer's
``di_train_profile_*`` gauges) against the JAX package's on the CPU.

* The same synthetic op events and phase windows go through both
  packages' ``build_report``: every number agrees (the kernel classes are
  the port's own and are tested on their own).
* The parser reads a real CPU trace this file records (a small port
  forward under span annotations), and a synthetic trace in the card's
  format: correlated launches (``cudaLaunchKernel``, ``cudaGraphLaunch``,
  ``cudaMemcpyAsync``), a kernel that ends after its launching window
  closed, a launch during another thread's window, backward launches
  from a thread without windows, kernels with no launch in any window.
* The trainer hook sets the gauges in unrounded seconds, and the CLI's
  final line passes ``tools/check_cli_contract.py attribution``.
"""

import gzip
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deepinteract_tpu.obs import attribution as jax_attr
from deepinteract_tpu.obs import device as jax_device
from deepinteract_tpu_torch.data.graph import stack_complexes
from deepinteract_tpu_torch.data.synthetic import random_complex
from deepinteract_tpu_torch.models.decoder import DecoderConfig
from deepinteract_tpu_torch.models.model import DeepInteract
from deepinteract_tpu_torch.obs import attribution as obs_attr
from deepinteract_tpu_torch.obs import device as obs_device
from deepinteract_tpu_torch.obs import metrics as obs_metrics
from deepinteract_tpu_torch.obs import spans
from deepinteract_tpu_torch.training.loop import LoopConfig, Trainer
from deepinteract_tpu_torch.training.optim import OptimConfig
from deepinteract_tpu_torch.weights import init_weights
from torch_port_helpers import KNN, port_cfg

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from tools.check_cli_contract import check_cli_contract_text  # noqa: E402

OPCODES = ("convolution", "dot", "fusion", "select", "copy", "reduce", "transpose")


def _synthetic(seed=7):
    """Op events and nested phase windows from one numpy seed, as (name,
    start, dur) tuples: names that both packages' grammars keep as their
    own family."""
    rng = np.random.default_rng(seed)
    windows = []
    for i in range(4):  # four dispatches, each a step with a device_step inside
        t0 = 10_000.0 * i
        windows.append(("epoch_part", t0, 9_000.0))
        windows.append(("device_step", t0 + 500.0, 6_000.0 + 100.0 * i))
        windows.append(("h2d", t0 + 7_000.0, 900.0))
    ops = []
    for _ in range(300):
        name = OPCODES[int(rng.integers(len(OPCODES)))]
        start = float(rng.uniform(0.0, 45_000.0))
        ops.append((name, start, float(rng.uniform(0.5, 300.0))))
    return ops, windows


def _both_traces(ops, windows):
    jt = jax_device.DeviceTrace(
        ops=[jax_device.OpEvent(n, s, d, 1, 2) for n, s, d in ops],
        phases=[jax_device.PhaseWindow(n, s, d) for n, s, d in windows],
        processes={1: "/host:CPU"})
    pt = obs_device.DeviceTrace(
        ops=[obs_device.OpEvent(n, s, d, 1, 2) for n, s, d in ops],
        phases=[obs_device.PhaseWindow(n, s, d) for n, s, d in windows],
        processes={1: "/host:CPU"})
    return jt, pt


def _numeric(rows, keys):
    return [{k: r.get(k) for k in keys} for r in rows]


def test_build_report_matches_jax_on_the_same_events():
    ops, windows = _synthetic()
    jt, pt = _both_traces(ops, windows)
    census = {"convolution": 6, "dot": 3, "select": 2, "custom-call": 1}
    kw = dict(top_n=5, analytic_flops={"device_step": 2e9, "h2d": 1e6},
              peak_flops=1e12, census=census, census_instances=4)
    want = jax_attr.build_report(jt, **kw)
    got = obs_attr.build_report(pt, **kw)
    for key in ("total_device_ms", "op_launches", "unattributed_ms", "peak_flops"):
        assert got[key] == want[key], key
    assert _numeric(got["top_ops"], ("name", "opcode", "count", "total_ms", "share")) == \
        _numeric(want["top_ops"], ("name", "opcode", "count", "total_ms", "share"))
    assert _numeric(got["by_opcode"], ("opcode", "count", "total_ms", "share")) == \
        _numeric(want["by_opcode"], ("opcode", "count", "total_ms", "share"))
    assert got["phases"] == want["phases"]
    assert [p["name"] for p in got["phases"]] == ["device_step", "epoch_part", "h2d"]
    assert {"mfu", "analytic_flops"} <= set(got["phases"][0])
    assert got["census_reconciliation"] == want["census_reconciliation"]
    # Attributed plus unattributed is the total, to rounding.
    attributed = sum(p["device_ms"] for p in got["phases"])
    assert attributed + got["unattributed_ms"] == pytest.approx(got["total_device_ms"],
                                                                abs=4e-4)


def test_phase_totals_are_the_unrounded_report():
    ops, windows = _synthetic(seed=11)
    _, pt = _both_traces(ops, windows)
    totals, unattributed_us = obs_attr.phase_totals(pt)
    report = obs_attr.attribute_phases(pt)
    for p in report["phases"]:
        assert p["device_ms"] == round(totals[p["name"]].device_us / 1e3, 4)
        assert p["instances"] == totals[p["name"]].instances
    assert sum(t.device_us for t in totals.values()) + unattributed_us == \
        pytest.approx(pt.total_device_us, rel=1e-12)


def test_kernel_families_and_classes():
    cases = {
        "void edge_attention_fwd_kernel<float, 4>(float const*, int)":
            ("edge_attention_fwd_kernel", "edge-attention-fwd"),
        "void edge_attention_bwd_dst_kernel<float>(float const*)":
            ("edge_attention_bwd_dst_kernel", "edge-attention-bwd"),
        "void at::native::vectorized_elementwise_kernel<4, at::native::AUnaryFunctor<float, "
        "float, float, at::native::binary_internal::MulFunctor<float> >, "
        "at::detail::Array<char*, 2> >(int, at::native::AUnaryFunctor<float, float, float, "
        "at::native::binary_internal::MulFunctor<float> >, at::detail::Array<char*, 2>)":
            ("vectorized_elementwise_kernel<mul>", "elementwise"),
        "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<"
        "at::native::(anonymous namespace)::where_kernel_impl(at::TensorIterator&)::"
        "{lambda()#1}::operator()() const::{lambda(bool, float, float)#1}>(at::"
        "TensorIteratorBase&)::{lambda(int)#1}>(int)": ("elementwise_kernel<where>", "elementwise"),
        "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::"
        "MeanOps<float, float, float, float>, unsigned int, float, 4, 4> >(at::native::"
        "ReduceOp<float, at::native::MeanOps<float, float, float, float>, unsigned int, "
        "float, 4, 4>)": ("reduce_kernel<mean>", "reduction"),
        "void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda("
        "at::TensorIteratorBase&)::{lambda()#3}::operator()() const::{lambda(float)#1}, "
        "at::detail::Array<char*, 2> >(int)": ("unrolled_elementwise_kernel<direct_copy>",
                                               "data-movement"),
        "sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n_tilesize128x128x32_warpgroupsize1x1x1_"
        "execute_segment_k_off_kernel__5x_cublas": (None, "matmul"),
        "void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_64x64_16x6_nn_align4>("
        "cutlass_80_tensorop_s1688gemm_64x64_16x6_nn_align4::Params)":
            ("Kernel2<cutlass_80_tensorop_s1688gemm_64x64_16x6_nn_align4>", "matmul"),
        "void cudnn::cnn::implicit_convolve_sgemm<float, float, 1024, 5, 5, 3, 3, 3, 1, "
        "false, false, true>(int, int)": ("implicit_convolve_sgemm", "matmul"),
        "void at::native::(anonymous namespace)::CatArrayBatchedCopy<float, unsigned int, 4, "
        "64, 64>(float*)": ("CatArrayBatchedCopy", "data-movement"),
        "void at::native::_to_copy_kernel<float>(float*)": ("_to_copy_kernel", "elementwise"),
        "Memcpy HtoD (Pageable -> Device)": ("Memcpy HtoD", "host-transfer"),
        "Memcpy DtoH (Device -> Pinned)": ("Memcpy DtoH", "host-transfer"),
        "Memcpy DtoD (Device -> Device)": ("Memcpy DtoD", "data-movement"),
        "Memset (Device)": ("Memset", "data-movement"),
        "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*)":
            ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "communication"),
        "aten::addmm": ("addmm", "matmul"),
        "aten::mul": ("mul", "elementwise"),
    }
    for name, (family, op_class) in cases.items():
        got = obs_device.opcode_of(name)
        if family is not None:
            assert got == family, name
        assert obs_attr.classify_opcode(got)[0] == op_class, (name, got)
    assert obs_attr.is_remask("vectorized_elementwise_kernel<mul>")
    assert obs_attr.is_remask("elementwise_kernel<where>") and obs_attr.is_remask("masked_fill")
    assert not obs_attr.is_remask("vectorized_elementwise_kernel<add>")


# ---------------------------------------------------------------------------
# The card's trace format, written by the test
# ---------------------------------------------------------------------------

HOST, PLACE, AUTOGRAD, OTHER, DEV = 100, 200, 300, 400, 0
K1 = "void edge_attention_fwd_kernel<float>(float const*, int)"
K2 = "void edge_attention_bwd_dst_kernel<float>(float const*)"
CONV = "void cudnn::cnn::implicit_convolve_sgemm<float, float>(int)"


def _x(cat, name, ts, dur, pid, tid, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts,
            "dur": dur, "args": args}


def cuda_format_trace():
    """A device_step window on the main thread holding an eager launch and a
    graph replay, an h2d window on the placement thread overlapping it in
    time (with its own copy), backward launches from a thread without
    windows (the autograd engine's), a launch outside every window, and a
    kernel whose launch is missing."""
    ev = [
        {"ph": "M", "name": "process_name", "pid": HOST, "tid": 0, "args": {"name": "python"}},
        {"ph": "M", "name": "process_name", "pid": DEV, "tid": 0, "args": {"name": "GPU 0"}},
        _x("user_annotation", "step#1", 900.0, 700.0, HOST, HOST),
        _x("user_annotation", "device_step", 1000.0, 500.0, HOST, HOST),
        _x("user_annotation", "h2d", 1100.0, 200.0, PLACE, PLACE),
        _x("user_annotation", "device_step", 3000.0, 100.0, HOST, HOST),
        # Its copy on the card is not a window.
        _x("gpu_user_annotation", "device_step", 1000.0, 2600.0, DEV, 7),
        _x("cpu_op", "aten::mul", 1005.0, 3.0, HOST, HOST),
        # Launches: eager, a graph replay (inside h2d's time, on the main
        # thread), the placement thread's copy, a launch in no window.
        _x("cuda_runtime", "cudaLaunchKernel", 1010.0, 4.0, HOST, HOST, correlation=1),
        _x("cuda_runtime", "cudaGraphLaunch", 1200.0, 30.0, HOST, HOST, correlation=2),
        _x("cuda_runtime", "cudaMemcpyAsync", 1150.0, 5.0, PLACE, PLACE, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 2000.0, 4.0, HOST, HOST, correlation=4),
        _x("cuda_driver", "cuLaunchKernel", 3010.0, 4.0, HOST, HOST, correlation=5),
        # The backward's thread: one launch inside both threads' windows, one
        # inside device_step only; another windowless thread in no window.
        _x("cuda_runtime", "cudaLaunchKernel", 1250.0, 4.0, AUTOGRAD, AUTOGRAD, correlation=6),
        _x("cuda_runtime", "cudaLaunchKernel", 1400.0, 4.0, AUTOGRAD, AUTOGRAD, correlation=7),
        _x("cuda_runtime", "cudaLaunchKernel", 2500.0, 4.0, OTHER, OTHER, correlation=8),
        # The device side.
        _x("kernel", K1, 1020.0, 10.0, DEV, 7, correlation=1),
        _x("kernel", CONV, 1240.0, 100.0, DEV, 7, correlation=2),
        _x("kernel", K2, 1340.0, 50.0, DEV, 7, correlation=2),
        _x("kernel", CONV, 1490.0, 200.0, DEV, 7, correlation=2),  # ends after the window
        _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 1700.0, 40.0, DEV, 9,
           correlation=3),
        _x("kernel", K1, 2010.0, 6.0, DEV, 7, correlation=4),
        _x("kernel", K1, 3020.0, 8.0, DEV, 7, correlation=5),
        _x("gpu_memset", "Memset (Device)", 3030.0, 2.0, DEV, 7, correlation=99),
        _x("kernel", K2, 1600.0, 20.0, DEV, 7, correlation=6),
        _x("kernel", K2, 1650.0, 30.0, DEV, 7, correlation=7),
        _x("kernel", K1, 2510.0, 5.0, DEV, 7, correlation=8),
        _x("Trace", "PyTorch Profiler (0)", 800.0, 2400.0, "Spans", "PyTorch Profiler"),
    ]
    return {"schemaVersion": 1, "deviceProperties": [{"id": 0, "name": "NVIDIA H100 80GB HBM3"}],
            "traceEvents": ev}


def test_cuda_format_trace_attributes_kernels_to_their_launch(tmp_path):
    path = tmp_path / "prof" / "host.1234.pt.trace.json.gz"
    path.parent.mkdir()
    path.write_bytes(gzip.compress(json.dumps(cuda_format_trace()).encode()))
    assert obs_device.find_trace_files(str(tmp_path / "prof")) == [str(path)]
    trace = obs_device.load_profile(str(tmp_path / "prof"))
    assert trace.device == "NVIDIA H100 80GB HBM3"
    assert trace.extent_us == 2800.0  # 800 us to the end of the device range
    # Device events only (the host's aten op is not a device op), and only
    # the user_annotation ranges as windows (step#1 fails the name rules).
    assert len(trace.ops) == 11 and trace.total_device_us == 471.0
    assert [(w.name, w.tid) for w in trace.phases] == [
        ("device_step", HOST), ("h2d", PLACE), ("device_step", HOST)]
    phases = dict(zip((op.start_us for op in trace.ops), obs_attr.assign_phases(trace)))
    assert phases[1490.0] == "device_step"  # late kernel: its launch's window
    assert phases[1240.0] == "device_step"  # launched inside h2d's time, other thread
    assert phases[1700.0] == "h2d"  # the placement thread's copy
    assert phases[2010.0] is None and phases[3030.0] is None  # no window / no launch
    assert phases[3020.0] == "device_step"  # a driver-API launch
    # The backward's thread counts for the thread whose windows hold its
    # launches, even inside the placement thread's h2d; a windowless
    # thread's launch in no window stays unattributed.
    assert phases[1600.0] == phases[1650.0] == "device_step"
    assert phases[2510.0] is None
    launches = {op.start_us: op.launch for op in trace.ops}
    assert launches[1490.0] == "cudaGraphLaunch" and launches[3020.0] == "cuLaunchKernel"
    assert launches[3030.0] == ""
    report = obs_attr.build_report(trace)
    by_phase = {p["name"]: p for p in report["phases"]}
    assert by_phase["device_step"]["device_ms"] == pytest.approx(0.418)
    assert by_phase["device_step"]["instances"] == 2
    assert by_phase["device_step"]["wall_ms"] == pytest.approx(0.6)
    assert by_phase["h2d"]["device_ms"] == pytest.approx(0.04)
    assert report["unattributed_ms"] == pytest.approx(0.013)
    classes = {r["opcode"]: r["op_class"] for r in report["by_opcode"]}
    assert classes == {"implicit_convolve_sgemm": "matmul", "edge_attention_fwd_kernel":
                       "edge-attention-fwd", "edge_attention_bwd_dst_kernel":
                       "edge-attention-bwd", "Memcpy HtoD": "host-transfer",
                       "Memset": "data-movement"}
    counts = {r["opcode"]: r["count"] for r in report["by_opcode"]}
    assert (counts["edge_attention_fwd_kernel"], counts["edge_attention_bwd_dst_kernel"]) == (4, 3)
    assert report["device"] == "NVIDIA H100 80GB HBM3"


def test_trainer_hook_sets_unrounded_gauges(tmp_path):
    prof = tmp_path / "prof"
    prof.mkdir()
    (prof / "trace.json").write_text(json.dumps(cuda_format_trace()))
    logs = []
    model = DeepInteract(port_cfg())
    trainer = Trainer(model, LoopConfig(profile_dir=str(prof), profile_steps=2),
                      OptimConfig(), log_fn=logs.append)
    trainer._attribute_profile()
    reg = obs_metrics.get_registry()
    total_s = reg.gauge("di_train_profile_device_total_seconds").value()
    per_dispatch = reg.gauge("di_train_profile_device_seconds_per_dispatch").value()
    # Unrounded: the sums of the event durations, in seconds.
    assert total_s == 471.0 / 1e6
    assert per_dispatch == (10.0 + 100.0 + 50.0 + 200.0 + 8.0 + 20.0 + 30.0) / 2 / 1e6
    assert per_dispatch <= total_s / 2
    assert any("profile attribution:" in m and "top ops:" in m
               and "deepinteract_tpu_torch.cli.attribute" in m for m in logs)

    logs.clear()
    trainer = Trainer(model, LoopConfig(profile_dir=str(tmp_path / "nothing_here")),
                      OptimConfig(), log_fn=logs.append)
    trainer._attribute_profile()
    assert any("profile attribution skipped" in m for m in logs)


# ---------------------------------------------------------------------------
# A real CPU trace of the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cpu_capture(tmp_path_factory):
    """Three annotated forwards of a small port model under the profiler,
    inside an outer span, with the span log written beside it."""
    work = tmp_path_factory.mktemp("capture")
    rng = np.random.default_rng(5)
    batch = stack_complexes([random_complex(26, 22, rng, n_pad1=32, n_pad2=32, knn=KNN)])
    model = DeepInteract(port_cfg())
    init_weights(model, 3)
    model.eval()
    events = str(work / "events.jsonl")
    with torch.no_grad():
        model(batch.graph1, batch.graph2)  # warm
        spans.configure(events)
        try:
            with obs_device.capture(str(work / "prof"), "cpu"):
                with spans.span("window"):
                    for _ in range(3):
                        with spans.span("device_step"):
                            model(batch.graph1, batch.graph2)
        finally:
            spans.close()
    assert not spans.annotations_enabled()
    return work, events


def test_real_cpu_trace_parses_and_attributes(cpu_capture):
    work, events = cpu_capture
    trace = obs_device.load_profile(str(work / "prof"))
    assert trace.files == [str(work / "prof" / "trace.json")] and trace.device == "cpu"
    assert [w.name for w in trace.phases] == ["window"] + ["device_step"] * 3
    assert len(trace.ops) > 100 and all(op.dur_us > 0 for op in trace.ops)
    assert any(obs_attr.classify_opcode(obs_device.opcode_of(op.name))[0] == "matmul"
               for op in trace.ops)
    assert trace.total_device_us <= trace.extent_us
    phases = obs_attr.attribute_phases(trace)
    by_name = {p["name"]: p for p in phases["phases"]}
    step = by_name["device_step"]
    assert step["instances"] == 3
    # The forwards' ops are on the spans' thread, inside their windows.
    assert 0 < step["device_ms"] <= step["wall_ms"]
    assert step["device_ms"] > 0.8 * (phases["unattributed_ms"] + step["device_ms"]
                                      + by_name["window"]["device_ms"])
    span_ms = sum(e["dur_s"] for e in spans.read_events(events)
                  if e["name"] == "device_step") * 1e3
    assert step["wall_ms"] == pytest.approx(span_ms, rel=0.10)


def test_cli_attribute_contract_on_a_cpu_trace(cpu_capture, capsys):
    from deepinteract_tpu_torch.cli.attribute import main

    work, events = cpu_capture
    out = str(work / "report.json")
    rc = main(["--profile_dir", str(work / "prof"), "--events", events,
               "--census", "decoder", "--census_pad", "16", "--census_instances", "3",
               "--device", "cpu", "--analytic_flops", "device_step=1e9",
               "--peak_flops", "1e12", "--out", out])
    assert rc == 0
    record = check_cli_contract_text(capsys.readouterr().out, "attribution")
    assert record["value"] > 0 and len(record["top_ops"]) == 3
    assert record["census_reconciled"] is True and "device_step" in record["phases"]
    with open(out) as fh:
        report = json.load(fh)
    assert report["schema"] == obs_attr.SCHEMA
    (step,) = [p for p in report["phases"] if p["name"] == "device_step"]
    assert step["trace_vs_span_wall_ratio"] == pytest.approx(1.0, abs=0.10)
    assert step["analytic_flops"] == pytest.approx(3e9) and step["mfu"] > 0
    assert report["census_meta"]["platform"] == "cpu"
    rows = {r["opcode"]: r for r in report["census_reconciliation"]}
    assert rows["convolution"]["census_count"] > 0
    assert "remask" in report and report["remask"]["census_launches"] > 0


def test_decoder_census_counts_a_forward_and_defaults_to_cuda():
    from deepinteract_tpu_torch.obs.kernelquery import decoder_census

    cfg = DecoderConfig(num_chunks=1, in_channels=8, num_channels=8)
    census, meta = decoder_census(pad=16, decoder_cfg=cfg, device="cpu")
    again, _ = decoder_census(pad=16, decoder_cfg=cfg, device="cpu")
    assert census == again and census["convolution"] > 0
    assert meta == {"device": "cpu", "platform": "cpu", "pad": 16, "masked": True,
                    "source": "decoder_forward"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            decoder_census(pad=16, decoder_cfg=cfg)


def test_profiled_training_run_sets_the_gauges_and_attributes(tmp_path, capsys):
    """A trainer's --profile_dir window on the CPU: the hook logs the
    attribution and sets both gauges, and cli.attribute on the same
    window agrees with the span log."""
    from deepinteract_tpu_torch.cli.attribute import main

    rng = np.random.default_rng(13)
    batches = [stack_complexes([random_complex(20, 16, rng, n_pad1=32, n_pad2=32, knn=KNN)])
               for _ in range(4)]
    model = DeepInteract(port_cfg())
    init_weights(model, 6)
    logs = []
    ckpt = tmp_path / "ck"
    trainer = Trainer(model, LoopConfig(num_epochs=1, seed=3, log_every=0, patience=50,
                                        ckpt_dir=str(ckpt), profile_dir=str(tmp_path / "p"),
                                        profile_steps=2),
                      OptimConfig(lr=1e-2, steps_per_epoch=4, num_epochs=2), log_fn=logs.append)
    reg = obs_metrics.get_registry()
    reg.gauge("di_train_profile_device_total_seconds").set(0.0)
    trainer.fit(trainer.init_state(), batches)
    (line,) = [m for m in logs if m.startswith("profile attribution:")]
    assert "2 dispatch(es)" in line
    total_s = reg.gauge("di_train_profile_device_total_seconds").value()
    per_dispatch = reg.gauge("di_train_profile_device_seconds_per_dispatch").value()
    assert 0 < per_dispatch <= total_s / 2
    rc = main(["--profile_dir", str(tmp_path / "p"), "--events",
               str(ckpt / "obs" / "events.jsonl")])
    assert rc == 0
    record = check_cli_contract_text(capsys.readouterr().out, "attribution")
    assert record["value"] == pytest.approx(total_s * 1e3, abs=1e-4)
    with open(record["report_out"]) as fh:
        report = json.load(fh)
    assert record["report_out"] == os.path.join(str(tmp_path / "p"), "op_attribution.json")
    (step,) = [p for p in report["phases"] if p["name"] == "device_step"]
    assert step["instances"] == 2
    assert step["device_ms"] / 2 == pytest.approx(per_dispatch * 1e3, abs=1e-4)
    assert step["trace_vs_span_wall_ratio"] == pytest.approx(1.0, abs=0.10)
