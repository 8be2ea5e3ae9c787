"""Each per-layer metric's reader on a small synthetic list of profiler
events, the trace reductions, and the import guard of the benchmark."""

import ast
import math
from pathlib import Path

import pytest

from benchmark import counts, harness
from benchmark.trace import Event, Trace

BENCH = Path(__file__).resolve().parents[1]
K1 = "void (anonymous namespace)::flash_attention_kernel<64>(CUtensorMap, int)"
LN = "void (anonymous namespace)::layer_norm_kernel(__nv_bfloat16 const*, int)"
GEMM = "void (anonymous namespace)::mlp_gemm_kernel<true>(CUtensorMap, int)"
ATEN_LN = "void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float>"
SELF = "void (anonymous namespace)::decode_attention_kernel<Bf16, __nv_bfloat16, false>(...)"
CROSS = "void (anonymous namespace)::decode_attention_group_kernel<Bf16, __nv_bfloat16, 1>(...)"
PERM = "void (anonymous namespace)::permute_kernel(PermuteArgs, int const*)"


def ctx(name="large-v3-turbo.archive-greedy"):
    cell = harness.make_cell(*name.split(".", 1))
    return {"config": cell.config, "traffic": cell.traffic, "prompt_len": 4}


def make_trace(kernels, passes=((128, 128, 1500), (1, 128, 330)), syncs=3,
               call=None):
    ev, t = [], 0
    for rows, mels, frames in passes:
        ev.append(Event("aten::conv1d", "op", t, 10, ((rows, mels, frames), (1280, mels, 3))))
        ev.append(Event("aten::conv1d", "op", t + 10, 10, ((rows, 1280, frames), (1280, 1280, 3))))
        t += 20
    for name, dur in kernels:
        ev.append(Event("cudaLaunchKernel", "runtime", t, 5))
        ev.append(Event(name, "kernel", t + 5, dur))
        t += 5 + dur + 100
    for _ in range(syncs):
        ev.append(Event("cudaStreamSynchronize", "runtime", t, 50))
        t += 60
    ev.append(Event("Memcpy DtoH (Device -> Pageable)", "memcpy", t, 40))
    call = call or {"windows": 4, "unprofiled_wall_s": 2e-6,
                    "window_flops": 989e12, "window_wall_s": 4.0}
    return Trace.from_events(ev, 1e-6 * t, call)


def test_rows_per_encoder_pass():
    tr = make_trace([(K1, 10)])
    assert harness.reader("rows_per_encoder_pass")(tr, ctx()) == 64.5
    assert harness.reader("rows_per_encoder_pass")(make_trace([], passes=()), ctx()) is None


def test_syncs_and_launches_per_window():
    tr = make_trace([(K1, 10), (LN, 10), (ATEN_LN, 10)], syncs=6)
    assert harness.reader("host_syncs_per_window")(tr, ctx()) == 6 / 4
    assert harness.reader("launches_per_window")(tr, ctx()) == 3 / 4  # no copies


def test_idle_share_and_busy():
    tr = make_trace([(K1, 100), (GEMM, 300)])
    assert tr.busy_ns() == 440  # two kernels and one copy
    assert harness.reader("idle_share")(tr, ctx()) == pytest.approx(100 * (1 - 440e-9 / 2e-6))
    over = Trace.from_events([Event("a", "kernel", 0, 100), Event("b", "kernel", 50, 100)], 1.0,
                             {"unprofiled_wall_s": 1.0})
    assert over.busy_ns() == 150  # a union, not a sum


def test_mfu():
    tr = make_trace([(K1, 10)])
    assert harness.reader("mfu")(tr, ctx()) == pytest.approx(25.0)


def test_encoder_roofline_counts_k1_and_k2_only():
    tr = make_trace([(K1, 400_000), (LN, 50_000), (GEMM, 2_000_000), (ATEN_LN, 9_999_999)])
    want = 0.0
    for rows, frames in ((128, 1500), (1, 330)):
        s = math.ceil(frames / 2)
        want += 32 * counts.bound_s(counts.flash_attention(rows, s, s, 1280))
        want += 32 * counts.bound_s(counts.encoder_mlp(rows * s, 1280, 5120))
    got = harness.reader("roofline.encoder_kernels")(tr, ctx())
    assert got == pytest.approx(100 * want / 2.45e-3)
    # K1 alone: K2's bound is not counted without its launches
    only = make_trace([(K1, 400_000)])
    k1 = sum(32 * counts.bound_s(counts.flash_attention(r, math.ceil(f / 2),
                                                        math.ceil(f / 2), 1280))
             for r, f in ((128, 1500), (1, 330)))
    assert harness.reader("roofline.encoder_kernels")(only, ctx()) == pytest.approx(100 * k1 / 4e-4)
    assert harness.reader("roofline.encoder_kernels")(make_trace([(SELF, 10)]), ctx()) is None


def test_decode_roofline_greedy_and_beam():
    c = ctx()
    tr = make_trace([(SELF, 1_000_000), (CROSS, 3_000_000)], passes=((128, 128, 1500),))
    want = sum(4 * (counts.bound_s(counts.decode_self([p + 1] * 128, 1280))
                     + counts.bound_s(counts.decode_cross(128, 128, 750, 1280)))
               for p in range(4, 67))
    assert harness.reader("roofline.decode_kernels")(tr, c) == pytest.approx(100 * want / 4e-3)
    b = ctx("large-v2.archive-beam5")
    tr = make_trace([(SELF, 1_000_000), (CROSS, 3_000_000), (PERM, 6_000_000)],
                    passes=((64, 80, 1500),))
    want = sum(32 * (counts.bound_s(counts.decode_self([p + 1] * 320, 1280))
                     + counts.bound_s(counts.decode_cross(320, 64, 750, 1280)))
               + counts.bound_s(counts.permute(320, 64, 32, p, 1280))
               for p in range(4, 67))
    assert harness.reader("roofline.decode_kernels")(tr, b) == pytest.approx(100 * want / 1e-2)


def test_idle_gaps_by_host_activity_and_top_ops():
    ev = [Event("aten::linear", "op", 0, 1000), Event("cudaLaunchKernel", "runtime", 100, 50),
          Event(K1, "kernel", 200, 100),
          Event("aten::item", "op", 1000, 500), Event("cudaStreamSynchronize", "runtime", 1100, 300),
          Event(GEMM, "kernel", 400, 900), Event(K1, "kernel", 2000, 100)]
    tr = Trace.from_events(ev, 1.0, {})
    # gaps: 300-400 (mid 350, inside aten::linear), 1300-2000 (mid 1650: no op)
    assert tr.idle_gaps() == [["host: no operator", 700e-9], ["aten::linear", 100e-9]]
    assert tr.top_device_ops() == [[GEMM, 900e-9], [K1, 200e-9]]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        names = set(_imports(path))
        assert not names & {"jax", "jaxlib", "flax", "whisper_tpu"}, path
        if "reference" in path.parts:
            assert "whisper_tpu_torch" not in names, path
