"""The step-anatomy plane of the port (``dinov3_tpu_torch/telemetry/trace.py``,
``anatomy.py``, ``memory.py``) against the JAX package's
(``dinov3_tpu/telemetry/``), on the CPU.

Tolerances: none. Interval arithmetic, step windows, summaries, the
fleet report and rounding are the reference's functions on the same
events and streams, so the results are equal; the hand-written Kineto
trace's ledger is exact (its durations are sums of a few binary
fractions of a microsecond, in ms: compared to 1e-12).
"""

import gzip
import json
import os

import pytest
import torch

from dinov3_tpu.telemetry import anatomy as J
from dinov3_tpu.telemetry.trace import TraceEvent as JEvent

from dinov3_tpu_torch.telemetry import anatomy as T
from dinov3_tpu_torch.telemetry.trace import TraceEvent, find_trace_file, load_trace

# tests/test_anatomy.py's vocabulary, and the XLA names of its categories
JAX_NAMES = (
    "all-reduce.17", "reduce-scatter.3", "collective-permute.1", "dot.42",
    "loop_convolution_fusion.2", "softmax_fusion", "exponential.1",
    "layer_norm_fusion", "multiply_reduce_fusion", "copy.1", "transpose.9",
    "loop_add_fusion.3", "custom-call.3", "fusion.2", "whatever",
    "convolution_add_fusion.1", "loop_add_fusion.1", "convert_element_type.5",
    "convert.2", "all-gather.4", "all-to-all.1", "psum", "rsqrt.3",
    "dynamic-slice.2", "gather.1", "reduce.7",
)

CUDA_NAMES = {
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1": "matmul/conv",
    "nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNT": "matmul/conv",
    "cutlass3x_sm90_tensorop_gemm_e4m3_e4m3_f32_f32_128x128x128_1x2x1": "matmul/conv",
    "void cutlass::Kernel2<cutlass_80_wmma_tensorop_s8_i8832gemm_s8_256x128_64x3_tn>": "matmul/conv",
    "void at::native::vectorized_elementwise_kernel<4, at::native::GeluCUDAKernelImpl>": "fusion/elementwise",
    "void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda>": "fusion/elementwise",
    "void at::native::elementwise_kernel<128, 2, at::native::exp_kernel_cuda>": "fusion/elementwise",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, MaxOps<float>>>": "norm/reduce",
    "Memcpy HtoD (Pinned -> Device)": "copy/layout",
    "Memset (Device)": "copy/layout",
    "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)": "collective",
    "flash_fwd_wgmma": "softmax/exp",
    "flash_bwd_dq_wgmma": "softmax/exp",
    "flash_bwd_dkv_wgmma": "softmax/exp",
    "flash_tile_schedule_kernel": "softmax/exp",
    "layernorm_fwd_vec": "norm/reduce",
    "layernorm_bwd_vec": "norm/reduce",
    "void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float>": "softmax/exp",
}


def test_categorize_gives_jax_s_answer_on_its_vocabulary():
    for name in JAX_NAMES:
        assert T.categorize(name) == J.categorize(name), name
    assert T.categorize("loop_add_fusion.1", fusion_dotty=True) == "matmul/conv"
    assert T.CATEGORIES == J.CATEGORIES
    assert (T.SCHEMA, T.SUMMARY_SCHEMA) == (J.SCHEMA, J.SUMMARY_SCHEMA)


@pytest.mark.parametrize("name,cat", sorted(CUDA_NAMES.items()))
def test_categorize_cuda_kernel_names(name, cat):
    assert T.categorize(name) == cat


def test_interval_arithmetic_equals_jax():
    cases = [[(5, 15), (0, 10), (20, 30), (30, 40), (50, 50)], [], [(3, 1)],
             [(0.5, 2.25), (2.0, 2.5), (7, 9), (8, 8.5)]]
    for ivs in cases:
        assert T.merge_intervals(ivs) == J.merge_intervals(ivs)
        merged = T.merge_intervals(ivs)
        for a, b in ((3, 25), (40, 60), (-5, 0), (0, 100), (10, 10), (2.1, 8.2)):
            assert T.intersect_length(a, b, merged) == J.intersect_length(a, b, merged)


@pytest.mark.parametrize("n_steps", [None, 1, 2, 3, 5])
def test_step_windows_equal_jax(n_steps):
    spec = [("a", 0, 10), ("b", 12, 10), ("c", 1000, 10), ("d", 1015, 10),
            ("e", 2000, 10), ("f", 2003, 1)]
    t = [TraceEvent(name=n, pid=1, tid=0, ts=float(s), dur=float(d)) for n, s, d in spec]
    j = [JEvent(name=n, pid=1, tid=0, ts=float(s), dur=float(d)) for n, s, d in spec]
    assert T.step_windows(t, n_steps) == J.step_windows(j, n_steps)
    assert T.step_windows([], n_steps) == J.step_windows([], n_steps) == []


def _jax_style_trace():
    """A TPU-style trace (one device pid, two streams) that JAX's
    ``anatomy_ledger`` reads by gap windows: its ledger feeds both
    ``ledger_summary`` functions."""
    from dinov3_tpu.telemetry.trace import Trace

    ev = [("dot.1", 0, 100, 0), ("all-reduce.1", 50, 100, 1), ("fusion.2", 100, 20, 0),
          ("dot.2", 5000, 80, 0), ("all-gather.3", 5100, 40, 1), ("copy.4", 5200, 10, 0)]
    return Trace(events=[JEvent(name=n, pid=7, tid=tid, ts=float(s), dur=float(d))
                         for n, s, d, tid in ev],
                 process_names={7: "/device:TPU:0"}, thread_names={})


def test_ledger_summary_and_round_floats_equal_jax():
    ledger = J.anatomy_ledger(_jax_style_trace(), n_steps=2)
    assert ledger["n_steps"] == 2
    assert T.ledger_summary(ledger) == J.ledger_summary(ledger)
    assert T.round_floats(ledger) == J.round_floats(ledger)
    assert T.round_floats(ledger, 2) == J.round_floats(ledger, 2)


def _write_streams(d):
    os.makedirs(d / "telemetry")
    for host, pitch, dw in (("", 100.0, 10.0), (".rank1", 100.0, 60.0),
                            (".rank2", 150.0, 12.0)):
        with open(d / "telemetry" / f"spans{host}.jsonl", "w") as f:
            for i in range(6):
                t = 1000.0 + i * pitch / 1e3
                for r in ({"name": "data_wait", "iteration": i, "t": t, "dur_ms": dw},
                          {"name": "dispatch", "iteration": i, "t": t, "dur_ms": 2.0},
                          {"name": "memory", "point": "flush", "iteration": i, "t": t}):
                    f.write(json.dumps({**r, "v": 1, "role": "train"}) + "\n")
            f.write(json.dumps({"name": "serve_device", "v": 1, "role": "serve"}) + "\n")
            f.write('{"name": "torn')  # a live writer's torn tail


def test_load_span_streams_and_fleet_report_equal_jax(tmp_path):
    _write_streams(tmp_path)
    for role in ("train", "serve", ""):
        assert T.load_span_streams(str(tmp_path), role) == \
            J.load_span_streams(str(tmp_path), role)
    streams = T.load_span_streams(str(tmp_path))
    assert sorted(streams) == ["rank0", "rank1", "rank2"]
    for anatomy in (None, {"exposed_comm_frac": 0.5}):
        for kw in ({}, {"input_bound_frac": 0.7}, {"straggler_z": 1.0}):
            assert T.fleet_report(streams, anatomy, **kw) == \
                J.fleet_report(streams, anatomy, **kw)
    assert T.fleet_report(str(tmp_path)) == J.fleet_report(str(tmp_path))


def _kineto_trace(path):
    """A hand-written Kineto trace: a CPU process (pid 100; the loop's
    thread 1, the autograd engine's thread 2) launching onto GPU 0 (pid 0,
    streams 7 and 8). Steps 3 and 4 are ``train_step#N`` annotations; a
    ``telemetry_ring`` scope, an autograd op, kernels, a memcpy, an NCCL
    all-reduce overlapping a GEMM, and a kernel launched outside any
    step."""
    ev = []

    def meta(name, pid, tid, value):
        ev.append({"name": name, "ph": "M", "pid": pid, "tid": tid, "args": {"name": value}})

    def x(name, cat, pid, tid, ts, dur, **args):
        ev.append({"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
                   "ts": ts, "dur": dur, "args": args})

    meta("process_name", 100, 0, "python3")
    meta("process_name", 0, 0, "GPU 0")
    meta("thread_name", 0, 7, "stream 7")
    x("train_step#3", "user_annotation", 100, 1, 0, 1000)
    x("telemetry_ring", "user_annotation", 100, 1, 800, 50)
    x("train_step#4", "user_annotation", 100, 1, 1000, 1000)
    x("autograd::engine::evaluate_function: MmBackward0", "cpu_op", 100, 2, 300, 200)
    x("aten::mm", "cpu_op", 100, 1, 5, 20, **{"External id": 11})
    launches = [  # (correlation, thread, launch ts, kernel, cat, stream, ts, dur)
        (1, 1, 10, "sm90_xmma_gemm_bf16bf16_bf16f32", "kernel", 7, 100, 200),
        (2, 2, 310, "flash_bwd_dq_wgmma", "kernel", 7, 320, 100),
        (3, 1, 810, "void at::native::vectorized_elementwise_kernel<4>", "kernel", 7, 830, 10),
        (4, 1, 1010, "layernorm_fwd_vec", "kernel", 7, 1100, 50),
        (5, 1, 1020, "Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 7, 1160, 40),
        (6, 1, 1030, "ncclDevKernel_AllReduce_Sum_f32", "kernel", 8, 1200, 100),
        (7, 1, 1040, "nvjet_tst_128x256", "kernel", 7, 1250, 100),
        (8, 1, 2500, "flash_fwd_wgmma", "kernel", 7, 2600, 30),
    ]
    for corr, tid, lts, name, cat, stream, ts, dur in launches:
        runtime = "cudaMemcpyAsync" if cat == "gpu_memcpy" else "cudaLaunchKernel"
        x(runtime, "cuda_runtime", 100, tid, lts, 2, correlation=corr, **{"External id": 11})
        x(name, cat, 0, stream, ts, dur, correlation=corr, device=0, stream=stream)
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": ev}, f)


def test_a_hand_written_kineto_trace_gives_its_exact_ledger(tmp_path):
    path = tmp_path / "trace" / "host_1.trace.json.gz"
    path.parent.mkdir()
    _kineto_trace(path)
    assert find_trace_file(str(tmp_path)) == str(path)
    trace = load_trace(str(path))
    assert [e.correlation for e in trace.op_events()] == list(range(1, 9))
    ledger = T.anatomy_ledger(str(tmp_path / "trace"))
    assert ledger["n_steps"] == 2 and ledger["timelines"] == ["GPU 0"]
    assert {it: [e.correlation for e in evs]
            for it, evs in T.events_by_step(trace).items()} == {3: [1, 2, 3],
                                                               4: [4, 5, 6, 7]}
    s3, s4 = ledger["steps"]
    assert (s3["iteration"], s4["iteration"]) == (3, 4)

    def close(a, b):
        assert abs(a - b) < 1e-12, (a, b)

    close(s3["wall_ms"], 0.74)
    close(s3["device_busy_ms"], 0.31)
    assert s3["device_ms"].keys() == {"matmul/conv", "softmax/exp", "fusion/elementwise"}
    close(s3["device_ms"]["matmul/conv"], 0.2)
    close(s3["device_ms"]["softmax/exp"], 0.1)
    close(s3["device_ms"]["fusion/elementwise"], 0.01)
    close(s3["backward_ms"], 0.1)       # the kernel the autograd op launched
    assert s3["collectives"] == {} and s3["scopes"] == {"telemetry_ring": 0.01}
    close(s4["wall_ms"], 0.25)
    close(s4["device_busy_ms"], 0.29)
    close(s4["device_ms"]["norm/reduce"], 0.05)
    close(s4["device_ms"]["copy/layout"], 0.04)
    close(s4["device_ms"]["collective"], 0.1)
    close(s4["device_ms"]["matmul/conv"], 0.1)
    coll = s4["collectives"]["unscoped"]
    close(coll["exposed_ms"], 0.05)     # half of it under the GEMM on stream 7
    close(coll["overlap_frac"], 0.5)
    assert coll["n_events"] == 1 and s4["backward_ms"] == 0.0
    close(ledger["unwindowed_ms"], 0.03)  # launched outside any step
    for s in (s3, s4):
        close(sum(s["device_ms"].values()), s["device_busy_ms"])
    summary = T.emit_step_anatomy(str(tmp_path / "trace"), n_steps=2)
    assert json.loads((tmp_path / "trace" / "anatomy.json").read_text())["n_steps"] == 2
    close(summary["device_busy_ms_per_step"], 0.3)
    close(summary["exposed_comm_ms_per_step"], 0.025)


def test_without_step_annotations_the_ledger_cuts_gap_windows(tmp_path):
    """A trace with no step annotation: each timeline is cut at its
    largest idle gaps, as JAX cuts it."""
    path = tmp_path / "t.trace.json.gz"
    ev = [{"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}}]
    for corr, (ts, dur) in enumerate([(0, 10), (12, 10), (1000, 10), (1015, 10)]):
        ev.append({"ph": "X", "cat": "kernel", "name": "gemm", "pid": 0, "tid": 7,
                   "ts": ts, "dur": dur, "args": {"correlation": corr}})
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": ev}, f)
    ledger = T.anatomy_ledger(load_trace(str(path)), n_steps=2)
    assert [s["device_busy_ms"] for s in ledger["steps"]] == [0.02, 0.02]
    assert [s["wall_ms"] for s in ledger["steps"]] == [0.022, 0.025]


def test_a_real_torch_profiler_cpu_trace_loads_and_makes_no_host_ledger(tmp_path):
    """``torch.profiler``'s own export, read back: its step annotation
    and CPU ops are there; with no device event the ledger refuses,
    rather than counting host time as the card's."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("train_step#0"):
            with torch.profiler.record_function("lowp_amax"):
                torch.ones(16, 16).abs().amax()
            torch.ones(16, 16) @ torch.ones(16, 16)
    path = str(tmp_path / "x.trace.json.gz")
    prof.export_chrome_trace(path)
    trace = load_trace(path)
    cats = {e.cat for e in trace.events}
    assert {"user_annotation", "cpu_op"} <= cats
    names = {e.name for e in trace.events}
    assert {"train_step#0", "lowp_amax", "aten::mm"} <= names
    assert trace.op_events() == [] and trace.process_names
    with pytest.raises(RuntimeError, match="no device event"):
        T.anatomy_ledger(trace)


def test_memory_instruments_on_the_cpu():
    from dinov3_tpu_torch.data import make_synthetic_batch
    from dinov3_tpu_torch.telemetry import per_device_state_bytes, sample_memory
    from dinov3_tpu_torch.train import build_train_setup

    from test_torch_train import cfgs

    assert sample_memory() == {"devices": []} or torch.cuda.is_available()
    for arm in ("bf16", "int8"):
        _, tcfg = cfgs([f"train.low_precision.arm={arm}"])
        setup = build_train_setup(tcfg, make_synthetic_batch(tcfg, 4, seed=0),
                                  device="cpu", seed=0)
        got = per_device_state_bytes(setup.state)
        params = sum(p.numel() * 4 for p in setup.meta.parameters())
        assert got["parts"]["params"] == params
        assert got["parts"]["opt_state"] == 2 * sum(
            p.numel() * 4 for p in setup.meta.student.parameters())
        rings = 0 if arm == "bf16" else 2 * 4 * setup.meta.student["backbone"].n_blocks * 16 * 4
        assert got["parts"]["lowp"] == rings
        assert got["total"] == sum(got["parts"].values()) == got["per_device"]["cpu"]
