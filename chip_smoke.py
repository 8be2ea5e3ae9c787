"""On-card smoke run of the PyTorch/CUDA port (`whisper_tpu_torch`).

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Phases, in order; any failure raises and the script exits non-zero:
  1. device  -- require CUDA, print the card's name and power limit;
  2. build   -- compile the port's kernels from `whisper_tpu_torch/csrc`
                (one nvcc per source, all at once);
  3. kernels -- each hand-written kernel against its plain PyTorch version
                at the large-v2 shapes of the slices, then larger ones,
                with error, tolerance, CUDA-event times of the kernel, its
                plain version and one PyTorch library call computing the
                same function (where there is one), and the kernel's bound
                (the least time the H100's data-sheet rates allow);
  4. greedy  -- large-v2 bf16 (random weights from a seed) greedy
                transcription of ~35 s of synthetic audio (3 windows)
                through `Transcriber.transcribe`, with every kernel's launch
                count read around that run, then the kernel path held
                against the plain path (attention="xla") on one window;
  5. beam    -- the same audio with the default `DecodeOptions()` (beam
                search, 5 beams, max_depth 100), cold and warm, every
                kernel's launch count read around the run, then prefill +
                8 beam steps on one window through both paths, fed the
                kernel path's tokens and parents: logits within PATH_RTOL,
                permuted caches equal to `torch.index_select`;
  6. quantized greedy -- int8 weight-only `quantize_params` of the same
                weights, greedy with int8 cross and self caches (K3 over
                int8, K3s), cold and warm, then the two paths on one window;
  7. quantized beam -- the bench's default configuration: beam 5 over the
                int8 weights, an int4 cross cache and an int8 self cache
                (K3g over int4, K5 with copy-on-write slots), cold and warm,
                then the two paths on one window;
  8. batched greedy -- bf16 `BatchTranscriber.transcribe_many` greedy over
                two 35 s streams (seeds 0 and 1): their 4 full windows as
                one batch (K1, K2, K3 at B = 4), the 2 tails one at a time;
                whether each text equals `Transcriber.transcribe`'s;
  9. w8a8 batched beam -- W8A8 weights (`quantize_params(...,
                quantize_encoder=True)`, `int8_impl="pallas"`), beam 5 over
                an int4 cross and an int8 self cache on the same streams:
                the batched encoder runs K7, the tails' encoder and every
                decoder matmul K6; cold and warm, then the two paths on the
                batch of 4 windows;
 10. sites      -- the two kernels no default path of the JAX package runs,
                at the call sites where JAX dispatches them: K9 through one
                window's encoder under `KernelKnobs(flash_impl="legacy")`
                (against the default K1 encoder and the plain encoder), K8
                through `_cached_attention(..., impl="flash")` at S = 1 on a
                greedy window's self cache and its bf16, int8 and int4
                cross caches (against impl="xla");
 11. timestamps + ladder -- bf16 `detect_language`, then
                `transcribe_with_timestamps` with beam 5, the temperature
                ladder (0, 0.2, 0.4) and no_speech_threshold 0.6 over the
                35 s audio, cold and warm: equal segments (the sampling
                rungs' seeded generators), the accepted temperature per
                window, 3 windows, monotone segment times in [0, 35] s;
 12. forced branches -- logits hooks force what random weights never
                reach (acceptance at rung 0, the no-speech gate, a ragged
                EOT across beam lanes and across a batched-greedy batch),
                each on the kernel and the plain path with equal tokens;
 13. int4 agreement -- `eval.agreement.decode_agreement` of the bf16
                weights against `quantize_params(bits=4,
                quantize_encoder=True)` under int8_impl="pallas" with int4
                cross and self caches, greedy and beam 5 over 2 seeded
                windows: K7 and K6 over packed int4 weights, K3s and K5
                over the int4 self cache; the report printed (not gated:
                random weights), every int4 variant launched, then the
                kernel path against the plain path on one window of that
                configuration, greedy and beam;
 14. batched timestamps + ladder -- bf16 `BatchTranscriber(batch_size=4)
                .transcribe_many_with_timestamps` over the two 35 s streams
                with beam 5, temperatures (0, 0.2, 0.4) and
                no_speech_threshold 0.6, cold and warm with equal segments:
                monotone segment times in [0, 35] s per stream, every window
                accepted at a rung or as silence, the accepted temperature
                per window and the windows each batched pass decoded; K1,
                K2, K3, K3g and K4 launched; whether each stream's segments
                equal `transcribe_with_timestamps`'s at temperature 0
                (reported, not asserted);
 15. words  -- greedy `transcribe_with_timestamps(word_timestamps=True)`
                over the 3-window stream: every segment with text has words
                (unless a word of an earlier segment aligned with it took its
                tokens), word times monotone within a segment and in [0, 35]
                s, the alignment's seconds beside the decode's; then one
                window's cross-attention weights (`align.
                cross_attention_weights`, plain torch) from the kernel
                path's encoder output against the plain path's, within
                PATH_RTOL;
 16. waveform_to_text -- the one-shot entry, greedy on the card over the
                35 s stream: its text must equal phase 4's;
 17. speculative -- `Transcriber(draft=..., draft_k=4)` with a multilingual
                tiny draft (d 384, random bf16 weights from SEED + 2) over
                the 35 s stream, cold and warm: its text must equal phase
                4's (else the first differing position and the top-2
                logit gap there on both paths are printed); K1, K2 and K3
                launched at d 384 and d 1280 (counted by width); then a
                self-draft over one window: plain greedy's tokens,
                acceptance >= SELF_DRAFT_ACCEPTANCE, every draft self-cache
                row in [P, length - 1) written and within PATH_RTOL of the
                target's;
 18. streaming -- one `StreamingTranscriber` (beam 5, max_depth 100, the
                compression gate off) over 20 s pushed in 1 s blocks, a
                decode every 4 s: confirmed text, decodes, seconds,
                monotone segment times in [0, 20] s; then 4 sessions on 4
                threads sharing one `StreamDecodeBatcher(batch_size=4)`:
                all finish, fewer batches than decodes, whether each
                equals its unbatched run (reported);
 19. serve  -- `BatchingWorker` + `make_handler` on a free port over a
                `BatchTranscriber(batch_size=4)`: 3 concurrent greedy
                requests through the window pool, their texts equal to
                `transcribe_many`'s; a timestamped SRT request; a /stream
                session of 10 s in 2 s s16 blocks; /healthz and /metrics
                (batches_total >= 1); both workers stopped and joined
                within 10 s.
The kernel phase holds the packed-int4 variants of K3s, K5, K6 and K7
beside their int8 rows (the *_int4 entries, counted apart). The kernel
phase also prints, for the kernels redesigned for Hopper (REDESIGNED: K1,
K9, K3g, K2, K3, K3s, K8, and K6, K7 and K5 with their int4 variants),
each time over its first version's (FIRST_VERSION_MS), over its library
call's (SDPA's; `torch._int_mm`'s for K6/K7) and, above 64 rows of K6/K7,
over a bf16 `torch.mm`'s of the same shape in the same call (K2: over the
encoder block's composed path, LN + two cuBLAS GEMMs + GELU + adds, which
its rows also time as composed_ms); the quantized greedy phase holds its logits against an f32
reference of the same quantized model (QUANT_F32_RTOL) and one dequant
matmul against its once-rounded f64 value (DEQUANT_EQUAL_SHARE). Every phase prints
its seconds. Every kernel but K8 and K9 must be launched by some slice;
K8 and K9 by their site checks. The line before the last is a JSON object
with one entry per kernel and int4 variant (launches summed over the
slices' cold runs and the int4 agreement run, or the site check's); the
last line is {"ok": true, "device": {...}}. K3's launches over cross caches
(`decode_attention_stacked.cross_launches`) are printed apart from its
launches over self caches, and stand as launches_cross in its entry; K6's
launches on the large-M route (`quantized_matmul.tile_launches`, int8 and
int4) apart from those at decode rows, as launches_tiles.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

try:
    import torch
except ImportError:  # pragma: no cover - the card's machine has torch
    print("chip_smoke: torch is not installed", file=sys.stderr)
    sys.exit(1)

SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of one call: `iters` back-to-back calls captured in
    a CUDA graph, replayed between two CUDA events, so a ~10 us kernel is
    not hidden behind the host's per-call launch cost. Warm-up calls run
    first, outside the capture (library load, allocator, cuBLAS handles)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()  # warm replay
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# The H100 SXM data sheet: HBM3 bandwidth and dense peak rates.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
              torch.int8: 1979e12}


# The kernels redesigned for Hopper (wgmma + TMA for K1/K9 and K2; a
# cluster split over the cache rows for K3g, and for K3 and K8 over a long
# cache; the one-block kernel of K3 and K8 over self caches and of K3s as
# one load round with per-warp softmax statistics; K6 at decode rows as
# one split-K launch, K6 above 64 rows and K7 as a prep pass and a TMA +
# wgmma GEMM; K5 as one launch with one round trip to memory) and the
# times of the versions before each redesign (WMMA K1/K9 and K2; K3g and
# K3 with one block per head and kv row; K3's one-block kernel with two
# rounds of loads; K6 as a row-quantize pass and a 32-column GEMM; K6 and
# K7 above 64 rows as a row-quantize pass and an mma.sync tile kernel; K5
# with three helper launches a call) at
# this script's shapes, in ms: the mean of two runs of
# `tools/compare_attention_kernels.py` on the commit before each redesign,
# on one card (PERF.md section 6 names the runs, NVIDIA H100 80GB HBM3,
# 700 W). Each new time is printed over these and over the library
# call's (K2: the composed path's) time in the same call; they are never
# put in the kernels line, which holds this run's numbers.
REDESIGNED = ("flash_attention", "flash_attention_legacy",
              "decode_attention_group", "encoder_mlp", "decode_attention",
              "decode_attention_scaled", "decode_attention_scaled_int4",
              "decode_attention_flat", "quantized_matmul",
              "quantized_matmul_int4", "quantized_matmul_big",
              "quantized_matmul_big_int4", "permute_attention",
              "permute_attention_int4")
FIRST_VERSION_MS = {
    ("flash_attention", "B=1 Sq=750 Sk=750 H=20"): 0.1210,
    ("flash_attention", "B=1 Sq=705 Sk=705 H=20"): 0.1208,
    ("flash_attention", "B=1 Sq=1500 Sk=1500 H=20"): 0.4860,
    ("flash_attention", "B=4 Sq=1500 Sk=1500 H=20"): 1.6615,
    ("flash_attention", "B=1 Sq=448 Sk=448 H=20 causal"): 0.0676,
    ("flash_attention", "B=1 Sq=4 Sk=1500 H=20"): 0.1502,
    ("flash_attention_legacy", "B=1 H=20 S=750"): 0.1206,
    ("flash_attention_legacy", "B=4 H=20 S=1500"): 1.6682,
    ("flash_attention_legacy", "B=1 H=20 S=224 causal"): 0.0266,
    ("decode_attention_group", "cross bf16 B=5 R=5 L=32 C=750"): 0.0192,
    ("decode_attention_group", "cross int8 B=5 R=5 L=32 C=750"): 0.0245,
    ("decode_attention_group", "cross int4 B=5 R=5 L=32 C=750"): 0.0202,
    ("decode_attention_group", "cross bf16 B=10 R=10 L=32 C=750"): 0.0198,
    ("decode_attention_group", "cross bf16 B=16 R=16 L=32 C=750"): 0.0232,
    ("decode_attention_group", "cross bf16 B=40 R=5 L=32 C=1500"): 0.0655,
    ("decode_attention_group", "cross bf16 B=20 R=5 L=32 C=750"): 0.0198,
    ("decode_attention_group", "cross f32 B=10 R=5 L=4 C=128"): 0.0065,
    # K2 and K3 over the cross cache (with K8) before their redesign: the
    # mean of the two runs of commit a07d64b in one call, in turns with
    # the redesign (PERF.md section 6 names the call)
    ("encoder_mlp", "M=750 d=1280 h=5120"): 0.4678,
    ("encoder_mlp", "M=1500 d=1280 h=5120"): 0.8055,
    # M=3000: the mean of a07d64b's two runs in a later call (PERF.md)
    ("encoder_mlp", "M=3000 d=1280 h=5120"): 1.9173,
    ("encoder_mlp", "M=6000 d=1280 h=5120"): 2.7707,
    ("decode_attention", "cross bf16 B=1 L=32 C=750"): 0.0112,
    ("decode_attention", "cross int8 B=1 L=32 C=750"): 0.0134,
    ("decode_attention", "cross int4 B=1 L=32 C=750"): 0.0119,
    ("decode_attention", "cross bf16 B=4 L=32 C=750"): 0.0115,
    ("decode_attention", "cross bf16 B=8 L=32 C=1500"): 0.0483,
    ("decode_attention_flat", "cross bf16 B=1 C=750 all rows"): 0.0112,
    ("decode_attention_flat", "cross int8 B=1 C=750 all rows"): 0.0134,
    ("decode_attention_flat", "cross int4 B=1 C=750 all rows"): 0.0120,
    # K6 (M <= 64) and K5 before their redesign: the mean of the two runs
    # of commit 03b1051 in one call, in turns with the redesign (PERF.md
    # section 6 names the call)
    ("quantized_matmul", "M=1 K=1280 N=3840"): 0.0063,
    ("quantized_matmul", "M=1 K=1280 N=1280"): 0.006,
    ("quantized_matmul", "M=1 K=1280 N=5120"): 0.008,
    ("quantized_matmul", "M=1 K=5120 N=1280"): 0.0124,
    ("quantized_matmul", "M=5 K=1280 N=3840"): 0.0071,
    ("quantized_matmul", "M=5 K=1280 N=1280"): 0.0066,
    ("quantized_matmul", "M=5 K=1280 N=5120"): 0.0088,
    ("quantized_matmul", "M=5 K=5120 N=1280"): 0.0148,
    ("quantized_matmul", "M=20 K=1280 N=3840"): 0.0092,
    ("quantized_matmul", "M=20 K=1280 N=1280"): 0.007,
    ("quantized_matmul", "M=20 K=1280 N=5120"): 0.0115,
    ("quantized_matmul", "M=20 K=5120 N=1280"): 0.0149,
    ("quantized_matmul_int4", "M=1 K=1280 N=3840"): 0.0068,
    ("quantized_matmul_int4", "M=1 K=1280 N=1280"): 0.0065,
    ("quantized_matmul_int4", "M=1 K=1280 N=5120"): 0.0084,
    ("quantized_matmul_int4", "M=1 K=5120 N=1280"): 0.0143,
    ("quantized_matmul_int4", "M=5 K=1280 N=3840"): 0.0076,
    ("quantized_matmul_int4", "M=5 K=1280 N=1280"): 0.0071,
    ("quantized_matmul_int4", "M=5 K=1280 N=5120"): 0.009,
    ("quantized_matmul_int4", "M=5 K=5120 N=1280"): 0.0166,
    ("quantized_matmul_int4", "M=20 K=5120 N=1280"): 0.0168,
    ("permute_attention",
     "B=5 L=32 C=128 pos=60 random parents COW dests"): 0.008,
    ("permute_attention",
     "B=5 L=32 C=128 pos=60 collapsed parents COW dests"): 0.0079,
    ("permute_attention",
     "B=5 L=32 C=128 pos=60 identity parents COW dests"): 0.0079,
    ("permute_attention",
     "B=5 L=32 C=128 pos=60 random parents dests=None (staged)"): 0.0168,
    ("permute_attention_int4",
     "int4 B=5 L=32 C=128 pos=60 random parents COW dests"): 0.008,
    ("permute_attention_int4",
     "int4 B=10 (W=2) L=32 C=128 pos=60 random parents COW dests"): 0.0082,
    # The one-block kernel (K3 and K8 over self caches, K3s) and the
    # large-M route (K6 above 64 rows, K7; int8 and int4) before their
    # redesign: the mean of the two runs of commit 91e0d80 in one call, in
    # turns with the redesign (PERF.md section 6 names the call)
    ("decode_attention", "self bf16 B=5 L=32 C=128"): 0.0034,
    ("decode_attention", "self bf16 B=1 L=32 C=128"): 0.0035,
    ("decode_attention", "self bf16 B=8 L=32 C=128"): 0.0045,
    ("decode_attention", "self f32 B=2 L=2 C=64 c_used=48"): 0.0034,
    ("decode_attention_scaled", "self int8 B=1 L=32 C=128"): 0.0036,
    ("decode_attention_scaled", "self int8 B=8 L=32 C=128 mixed pos"): 0.0055,
    ("decode_attention_scaled_int4", "self int4 B=1 L=32 C=128"): 0.0035,
    ("decode_attention_scaled_int4",
     "self int4 B=5 L=32 C=128 mixed pos"): 0.0048,
    ("decode_attention_flat", "self bf16 B=1 C=448 pos=[60]"): 0.0034,
    ("decode_attention_flat",
     "self bf16 B=5 C=448 pos=[60, 3, 200, 447, 0]"): 0.0076,
    ("quantized_matmul", "M=750 K=1280 N=3840"): 0.0397,
    ("quantized_matmul", "M=750 K=1280 N=1280"): 0.0243,
    ("quantized_matmul", "M=750 K=1280 N=5120"): 0.0421,
    ("quantized_matmul", "M=750 K=5120 N=1280"): 0.0776,
    ("quantized_matmul_int4", "M=750 K=1280 N=3840"): 0.0426,
    ("quantized_matmul_big", "M=3000 K=1280 N=3840"): 0.1168,
    ("quantized_matmul_big", "M=3000 K=1280 N=1280"): 0.0458,
    ("quantized_matmul_big", "M=3000 K=1280 N=5120"): 0.15,
    ("quantized_matmul_big", "M=3000 K=5120 N=1280"): 0.1495,
    ("quantized_matmul_big", "M=1537 K=1280 N=3840"): 0.0625,
    ("quantized_matmul_big_int4", "M=1500 K=1280 N=3840"): 0.0666,
    ("quantized_matmul_big_int4", "M=1500 K=5120 N=1280"): 0.1006,
    ("quantized_matmul_big_int4", "M=3000 K=1280 N=3840"): 0.1248,
    ("quantized_matmul_big_int4", "M=3000 K=5120 N=1280"): 0.161,
}


def bound(n_bytes: float, flops: float, dtype=torch.bfloat16) -> tuple:
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the operations over the peak rate of their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def compare(name: str, got, want, atol: float, rtol: float) -> tuple:
    """(max abs error, max of error / (atol + rtol*|want|)); raises if any
    element is outside atol + rtol*|want| (atol = rtol = 0: bit-exact).
    Tuples of tensors are compared pairwise."""
    if isinstance(got, (tuple, list)):
        res = [compare(name, g, w, atol, rtol) for g, w in zip(got, want)]
        return max(r[0] for r in res), max(r[1] for r in res)
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got - want).abs()
    tol = atol + rtol * want.abs()
    bad = err > tol
    max_err = float(err.max())
    ratio = float((err / tol).max()) if atol or rtol else 0.0
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside atol={atol} "
            f"rtol={rtol} (max abs err {max_err})")
    return max_err, ratio


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this script runs only on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the plain references "
                             "assume full f32")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> None:
    from whisper_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    path = _build.library_path()
    _build.library()
    log(f"build: {path.name} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds})")
    ptxas = path.with_suffix(".log")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line.lower():
                log("  ptxas: " + line.strip())


def _randn(shape, gen, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def phase_kernels() -> dict:
    """Each kernel vs its plain version: first at the shapes the slices'
    main paths give it (large-v2: a 14.9 s window is 1500 mel frames, so
    the encoder runs S = M = Sa = 750; greedy decodes 1 lane, beam 5
    lanes against one window's cross cache), then at larger ones."""
    import torch.nn.functional as F

    from whisper_tpu_torch.ops.kernels import decode_attention as KC
    from whisper_tpu_torch.ops.kernels import encoder_block as KB
    from whisper_tpu_torch.ops.kernels import flash_attention as KA
    from whisper_tpu_torch.ops.kernels import permute as KP
    from whisper_tpu_torch.ops.kernels import permute_attention as KF
    from whisper_tpu_torch.quantize import pack_int4

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    d, heads, hidden, hd = 1280, 20, 5120, 64
    rows = {name: [] for name, *_ in KERNELS}

    def record(name, shape, call, plain_call, atol, rtol, work,
               library_call=None, dtype=torch.bfloat16, **extra):
        err, ratio = compare(f"{name} [{shape}]", call(), plain_call(), atol,
                             rtol)
        bound_ms, bound_by = bound(*work, dtype)
        rows[name].append(dict(
            shape=shape, max_abs_err=err, atol=atol, rtol=rtol,
            err_over_tol=ratio, ms=time_ms(call),
            plain_ms=time_ms(plain_call), bound_ms=bound_ms,
            bound_by=bound_by,
            library_ms=None if library_call is None else time_ms(library_call),
            **{k: time_ms(f) for k, f in extra.items()}))

    def heads_view(x, n):  # (B, n, d) -> (B, H, n, hd), a view
        return x.view(x.shape[0], n, heads, hd).transpose(1, 2)

    # A: self-attention q/k/v are the strided slices of one fused QKV
    # output, as in the encoder; causal and Sq != Sk are off the slice's path.
    # v has mean 1, so |out| is near 1 and a softmax that let the zero-filled
    # keys past Sk in (a lost key-length mask) would shrink every output by
    # far more than the tolerance; Sk = 705 leaves 63 of its last 64-key
    # tile padded.
    for b, sq, sk, causal in ((1, 750, 750, False), (1, 705, 705, False),
                              (1, 1500, 1500, False), (4, 1500, 1500, False),
                              (1, 448, 448, True), (1, 4, 1500, False)):
        if sq == sk:
            qkv = _randn((b, sq, 3, d), gen)
            qkv[:, :, 2] += 1
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        else:
            q, k = _randn((b, sq, d), gen), _randn((b, sk, d), gen)
            v = _randn((b, sk, d), gen) + 1
        pairs = sq * (sq + 1) / 2 if causal else sq * sk
        record("flash_attention",
               f"B={b} Sq={sq} Sk={sk} H={heads}{' causal' if causal else ''}",
               lambda: KA.attention_bhsd(q, k, v, heads, causal),
               lambda: KA.attention_bhsd_plain(q, k, v, heads, causal),
               KA.ATOL, KA.RTOL,
               ((2 * b * sq * d + 2 * b * sk * d) * 2, 4 * b * heads * pairs * hd),
               lambda: F.scaled_dot_product_attention(
                   heads_view(q, sq), heads_view(k, sk), heads_view(v, sk),
                   is_causal=causal))

    # A.legacy: K9 on (B, H, S, hd) views of the (B, S, H, hd) projections,
    # q pre-scaled, as `attention_bhsd(impl="legacy")` hands them over: a
    # window's encoder shape, the 4-window batch, and a causal square.
    for b, s_len, causal in ((1, 750, False), (4, 1500, False),
                             (1, 224, True)):
        qkv = _randn((b, s_len, 3, d), gen)
        qkv[:, :, 2] += 1
        q = heads_view(qkv[:, :, 0] * hd ** -0.5, s_len)
        k, v = heads_view(qkv[:, :, 1], s_len), heads_view(qkv[:, :, 2], s_len)
        pairs = s_len * (s_len + 1) / 2 if causal else s_len * s_len
        record("flash_attention_legacy",
               f"B={b} H={heads} S={s_len}{' causal' if causal else ''}",
               lambda: KA.flash_attention(q, k, v, causal),
               lambda: KA.flash_attention_plain(q, k, v, causal),
               KA.ATOL, KA.RTOL,
               (4 * b * s_len * d * 2, 4 * b * heads * pairs * hd),
               lambda: F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=causal,
                                                      scale=1.0))

    # B: weights at the init scale, LN affine away from identity: one
    # window (750 rows), two (1500), four (3000: the batched greedy slice's
    # 4 windows, a 56-row tail tile) and eight (6000). No single PyTorch
    # call computes LN + MLP + GELU + residual; composed_ms times the
    # encoder block's unfused branch on the same inputs (LN, two cuBLAS
    # GEMMs, GELU, the bias and residual adds: `models/whisper.py::_mlp`).
    import whisper_tpu_torch.models.whisper as M

    ln_g = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).bfloat16()
    ln_b = _randn((d,), gen, 0.1)
    w1, b1 = _randn((d, hidden), gen, 0.02), _randn((hidden,), gen, 0.02)
    w2, b2 = _randn((hidden, d), gen, 0.02), _randn((d,), gen, 0.02)
    mlp_p = {"mlp_ln_g": ln_g, "mlp_ln_b": ln_b, "mlp1_w": w1, "mlp1_b": b1,
             "mlp2_w": w2, "mlp2_b": b2}
    for m in (750, 1500, 3000, 6000):
        args = (_randn((m, d), gen), ln_g, ln_b, w1, b1, w2, b2)
        record("encoder_mlp", f"M={m} d={d} h={hidden}",
               lambda: KB.fused_mlp_block(*args),
               lambda: KB.fused_mlp_block_plain(*args), KB.ATOL, KB.RTOL,
               ((2 * m * d + 2 * d * hidden + hidden + 3 * d) * 2,
                4 * m * d * hidden),
               composed_ms=lambda: M._mlp(args[0], mlp_p, 1e-5))

    # C: self caches (B, L, C, d) with mixed pos, cross caches (L, B, Sa, d)
    # with every row visible; the beam path's shape (5 lanes) first, then
    # the greedy path's two. C.g: the grouped kernel, R q rows per
    # cross-cache row (R = 10 and 16: two groups of lanes a kv row). v of
    # mean 1 (positive integers for an integer cache), so a dropped mask
    # shows. Integer caches (int8, packed int4) take a bf16 query scaled as
    # the model's folded K scale leaves it; no PyTorch attention call takes
    # integer K/V, so their library column is empty.
    bf16, f32 = torch.bfloat16, torch.float32
    for name, kind, b, rep, n_layer, c, st, pos, cu in (
            ("decode_attention", "self", 5, 1, 32, 128, "bf16",
             [40] * 5, None),
            ("decode_attention", "self", 1, 1, 32, 128, "bf16", [37], None),
            ("decode_attention", "cross", 1, 1, 32, 750, "bf16", None, None),
            ("decode_attention", "cross", 1, 1, 32, 750, "int8", None, None),
            ("decode_attention", "cross", 1, 1, 32, 750, "int4", None, None),
            ("decode_attention", "cross", 4, 1, 32, 750, "bf16", None, None),
            ("decode_attention", "self", 8, 1, 32, 128, "bf16",
             [0, 5, 17, 63, 64, 100, 126, 127], None),
            ("decode_attention", "cross", 8, 1, 32, 1500, "bf16", None, None),
            ("decode_attention", "self", 2, 1, 2, 64, "f32", [3, 40], 48),
            ("decode_attention_group", "cross", 5, 5, 32, 750, "bf16", None,
             None),
            ("decode_attention_group", "cross", 5, 5, 32, 750, "int8", None,
             None),
            ("decode_attention_group", "cross", 5, 5, 32, 750, "int4", None,
             None),
            ("decode_attention_group", "cross", 10, 10, 32, 750, "bf16",
             None, None),
            ("decode_attention_group", "cross", 16, 16, 32, 750, "bf16",
             None, None),
            ("decode_attention_group", "cross", 40, 5, 32, 1500, "bf16", None,
             None),
            ("decode_attention_group", "cross", 20, 5, 32, 750, "bf16", None,
             None),
            ("decode_attention_group", "cross", 10, 5, 4, 128, "f32", None,
             None)):
        bm = kind == "self"
        bk = b // rep
        shape = (bk, n_layer, c, d) if bm else (n_layer, bk, c, d)
        dt = f32 if st == "f32" else bf16
        lim = {"int8": 127, "int4": 7}.get(st)
        if lim is None:
            kc = _randn(shape, gen, dtype=dt)
            vc = (_randn(shape, gen, dtype=f32) + (rep > 1)).to(dt)
            q = _randn((b, d), gen, 0.125, dtype=dt)
        else:
            kc = torch.randint(-lim, lim + 1, shape, generator=gen,
                               device="cuda", dtype=torch.int8)
            vc = torch.randint(0, lim + 1, shape, generator=gen,
                               device="cuda", dtype=torch.int8)
            q = _randn((b, d), gen, 0.5 / lim)
            if st == "int4":
                kc, vc = pack_int4(kc), pack_int4(vc)
        pos_t = torch.tensor([c - 1] * b if pos is None else pos,
                             dtype=torch.int32, device="cuda")
        layer = 7 % n_layer
        n_vis = [min(p + 1, cu or c) for p in pos_t.tolist()]
        row_bytes = kc.shape[3] * kc.element_size()  # int4: d / 2 bytes
        if rep == 1:  # every lane reads its own rows
            read = sum(2 * n * row_bytes for n in n_vis)
        else:  # one read of each window's rows serves its R lanes
            read = sum(2 * n_vis[j * rep] * row_bytes for j in range(bk))
        qb = q.element_size()
        work = (read + 2 * b * d * qb + 4 * b, sum(4 * n * d for n in n_vis))
        ncu = cu or c
        library = None
        if lim is None:
            kl = kc[:, layer] if bm else kc[layer]
            vl = vc[:, layer] if bm else vc[layer]
            kh, vh = heads_view(kl[:, :ncu], ncu), heads_view(vl[:, :ncu],
                                                              ncu)
            if rep == 1:
                qh = heads_view(q[:, None], 1)
                mask = (torch.arange(ncu, device="cuda")[None, None, None, :]
                        <= pos_t[:, None, None, None])
            else:  # the R lanes of a window as R queries of one head row
                qh = heads_view(q.view(bk, rep, d), rep)
                mask = None

            def library(qh=qh, kh=kh, vh=vh, mask=mask):
                return F.scaled_dot_product_attention(qh, kh, vh,
                                                      attn_mask=mask,
                                                      scale=1.0)
        record(name,
               f"{kind} {st} B={b}" + (f" R={rep}" if rep > 1 else "")
               + f" L={n_layer} C={c}" + (f" c_used={cu}" if cu else ""),
               lambda: KC.decode_attention_stacked(
                   q, kc, vc, pos_t, layer, heads, batch_major=bm,
                   kv_rep=rep, c_used=cu),
               lambda: KC.decode_attention_stacked_plain(
                   q, kc, vc, pos_t, layer, heads, batch_major=bm,
                   kv_rep=rep, c_used=cu),
               *KC.TOL[dt], work, library, dtype=dt)
        del kc, vc, library

    # C.flat: K8, one layer's flat (B, C, d) cache sliced out of a stacked
    # buffer: a self cache of C = 448 rows at pos 60 (one lane, then 5 lanes
    # with per-row pos), then cross caches of Sa = 750 rows, every row
    # visible, bf16, int8 and int4. Library (bf16 rows): SDPA with a
    # (B, H, 1, hd) query and a boolean mask.
    for kind, b, c, st, pos in (("self", 1, 448, "bf16", [60]),
                                ("self", 5, 448, "bf16", [60, 3, 200, 447, 0]),
                                ("cross", 1, 750, "bf16", None),
                                ("cross", 1, 750, "int8", None),
                                ("cross", 1, 750, "int4", None)):
        lim = {"int8": 127, "int4": 7}.get(st)
        shape = (b, 4, c, d)
        if lim is None:
            kc, vc = _randn(shape, gen), _randn(shape, gen) + 1
            q = _randn((b, d), gen, 0.125)
        else:
            kc = torch.randint(-lim, lim + 1, shape, generator=gen,
                               device="cuda", dtype=torch.int8)
            vc = torch.randint(0, lim + 1, shape, generator=gen,
                               device="cuda", dtype=torch.int8)
            q = _randn((b, d), gen, 0.5 / lim)
            if st == "int4":
                kc, vc = pack_int4(kc), pack_int4(vc)
        kl, vl = kc[:, 2], vc[:, 2]  # layer 2 of the stacked buffer
        pos_t = torch.tensor([c - 1] * b if pos is None else pos,
                             dtype=torch.int32, device="cuda")
        n_vis = [p + 1 for p in pos_t.tolist()]
        row_bytes = kl.shape[2] * kl.element_size()
        work = (sum(2 * n * row_bytes for n in n_vis) + 2 * b * d * 2 + 4 * b,
                sum(4 * n * d for n in n_vis))
        library = None
        if lim is None:
            mask = (torch.arange(c, device="cuda")[None, None, None, :]
                    <= pos_t[:, None, None, None])

            def library(qh=heads_view(q[:, None], 1), kh=heads_view(kl, c),
                        vh=heads_view(vl, c), mask=mask):
                return F.scaled_dot_product_attention(qh, kh, vh,
                                                      attn_mask=mask,
                                                      scale=1.0)
        record("decode_attention_flat",
               f"{kind} {st} B={b} C={c}"
               + (f" pos={pos}" if pos else " all rows"),
               lambda: KC.decode_attention(q, kl, vl, pos_t, heads),
               lambda: KC.decode_attention_plain(q, kl, vl, pos_t, heads),
               *KC.TOL[bf16], work, library)
        del kc, vc, kl, vl, library

    # E: K3s, the int8 self cache with row scales: the greedy slice's shape
    # (1 lane, C = 128), then 8 lanes with mixed pos and a NaN scale on
    # each lane's first masked row. No PyTorch call takes int8 K/V with row
    # scales.
    for b, pos in ((1, [37]), (8, [0, 5, 17, 63, 64, 100, 125, 126])):
        shape = (b, 32, 128, d)
        kc, vc = (torch.randint(-127, 128, shape, generator=gen,
                                device="cuda", dtype=torch.int8)
                  for _ in "kv")
        ks, vs = (0.002 + 0.01 * torch.rand(shape[:3], generator=gen,
                                            device="cuda") for _ in "kv")
        pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
        lanes = torch.arange(b, device="cuda")
        ks[lanes, 7, pos_t.long() + 1] = float("nan")
        vs[lanes, 7, pos_t.long() + 1] = float("nan")
        q = _randn((b, d), gen, 0.125)
        n_vis = [p + 1 for p in pos]
        work = (sum(2 * n * (d + 4) for n in n_vis) + 2 * b * d * 2,
                sum(4 * n * d for n in n_vis))
        record("decode_attention_scaled",
               f"self int8 B={b} L=32 C=128" + (" mixed pos" if b > 1 else ""),
               lambda: KC.decode_attention_stacked(
                   q, kc, vc, pos_t, 7, heads, batch_major=True,
                   k_rowscale=ks, v_rowscale=vs),
               lambda: KC.decode_attention_stacked_plain(
                   q, kc, vc, pos_t, 7, heads, batch_major=True,
                   k_rowscale=ks, v_rowscale=vs),
               *KC.TOL[bf16], work)
        del kc, vc, ks, vs

    # E.int4: K3s over the packed-int4 self cache (values in [-7, 7], d / 2
    # bytes a row): the int4 agreement slice's greedy shape (1 lane, C =
    # 128), then beam 5's lanes with mixed pos and a NaN scale on each
    # lane's first masked row. No PyTorch call takes int4 K/V.
    for b, pos in ((1, [37]), (5, [0, 17, 63, 100, 126])):
        shape = (b, 32, 128, d)
        kc, vc = (pack_int4(torch.randint(-7, 8, shape, generator=gen,
                                          device="cuda", dtype=torch.int8))
                  for _ in "kv")
        ks, vs = (0.02 + 0.1 * torch.rand(shape[:3], generator=gen,
                                          device="cuda") for _ in "kv")
        pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
        lanes = torch.arange(b, device="cuda")
        ks[lanes, 7, pos_t.long() + 1] = float("nan")
        vs[lanes, 7, pos_t.long() + 1] = float("nan")
        q = _randn((b, d), gen, 0.125)
        n_vis = [p + 1 for p in pos]
        work = (sum(2 * n * (d // 2 + 4) for n in n_vis) + 2 * b * d * 2,
                sum(4 * n * d for n in n_vis))
        record("decode_attention_scaled_int4",
               f"self int4 B={b} L=32 C=128" + (" mixed pos" if b > 1 else ""),
               lambda: KC.decode_attention_stacked(
                   q, kc, vc, pos_t, 7, heads, batch_major=True,
                   k_rowscale=ks, v_rowscale=vs),
               lambda: KC.decode_attention_stacked_plain(
                   q, kc, vc, pos_t, 7, heads, batch_major=True,
                   k_rowscale=ks, v_rowscale=vs),
               *KC.TOL[bf16], work)
        del kc, vc, ks, vs

    # F: K5 at the beam slice's shape, one window of 5 lanes at pos 60:
    # random, collapsed and identity parents with copy-on-write dests from
    # `_cow_assign` over a shuffled slot map, then random parents with
    # dests=None (identity slots, which the wrapper stages); then the int4
    # agreement slice's packed-int4 caches (values in [-7, 7], d / 2 bytes
    # a row) with random parents and COW dests, over one window and over
    # the two windows (B = 10) that its beam runs, parents window-local.
    # The kernel and the plain version run on two copies of the same
    # caches: the attention within K3's tolerance, all four updated arrays
    # bit-equal. No PyTorch call reshuffles, appends and attends.
    from whisper_tpu_torch.decode.beam import _cow_assign

    k, ps = 5, 60
    for name, row, cases in (
            ("permute_attention", d, (("random", True, 1),
                                      ("collapsed", True, 1),
                                      ("identity", True, 1),
                                      ("random", False, 1))),
            ("permute_attention_int4", d // 2, (("random", True, 1),
                                                ("random", True, 2)))):
        int4 = row != d

        def ints(shape):
            if not int4:
                return torch.randint(-127, 128, shape, generator=gen,
                                     device="cuda", dtype=torch.int8)
            return pack_int4(torch.randint(-7, 8, shape, generator=gen,
                                           device="cuda", dtype=torch.int8))

        for kind, cow, w in cases:
            b = k * w
            shape = (b, 32, 128, d)
            caches = [ints(shape) for _ in "kv"]
            caches += [0.002 + 0.01 * torch.rand(shape[:3], generator=gen,
                                                 device="cuda") for _ in "kv"]
            new = [ints((b, d)) for _ in "kv"]
            new += [0.002 + 0.01 * torch.rand(b, generator=gen, device="cuda")
                    for _ in "kv"]
            q = _randn((b, d), gen, 0.125)
            phys = torch.stack([torch.randperm(k, generator=gen, device="cuda")
                                for _ in range(w)])
            parent = {"random": torch.randint(0, k, (w, k), generator=gen,
                                              device="cuda"),
                      "collapsed": torch.full((w, k), 2, device="cuda"),
                      "identity": torch.arange(k, device="cuda").repeat(w, 1)
                      }[kind]
            offs = (torch.arange(w, device="cuda") * k)[:, None]
            dests = None
            if cow:
                parent, dests = _cow_assign(parent, phys)
                dests = (dests + offs).reshape(-1)
            parent = (parent + offs).reshape(-1)
            par = parent.tolist()
            moved = [True] * b if dests is None else [
                a != c for a, c in zip(par, dests.tolist())]
            n = ps + 1
            read = (len(set(par)) * 2 * ps * (row + 4) + 2 * b * (row + 4)
                    + b * d * 2)
            written = (sum(2 * (n if m else 1) * (row + 4) for m in moved)
                       + b * d * 2)
            args = lambda arrays: (q, *arrays, *new, parent, ps, 7, heads, k)
            mine = [x.clone() for x in caches]
            plain = [x.clone() for x in caches]
            got = KF.decode_attention_permute_fused(*args(mine), dests=dests)
            want = KF.decode_attention_permute_fused_plain(*args(plain),
                                                           dests=dests)
            err, ratio = compare(f"{name} [{kind} W={w}]", got[0], want[0],
                                 *KC.TOL[bf16])
            compare(f"{name} [{kind} W={w}] caches", got[1:], want[1:],
                    0.0, 0.0)
            bound_ms, bound_by = bound(read + written, 4 * b * n * d)
            rows[name].append(dict(
                shape=("int4 " if int4 else "")
                + f"B={b}" + (f" (W={w})" if w > 1 else "")
                + f" L=32 C=128 pos={ps} {kind} parents "
                + ("COW dests" if cow else "dests=None (staged)"),
                max_abs_err=err, atol=KC.TOL[bf16][0], rtol=KC.TOL[bf16][1],
                err_over_tol=ratio, caches_bit_equal=True,
                ms=time_ms(lambda: KF.decode_attention_permute_fused(
                    *args(mine), dests=dests)),
                plain_ms=time_ms(
                    lambda: KF.decode_attention_permute_fused_plain(
                        *args(plain), dests=dests)),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
            del mine, plain, caches

    # D: the beam reshuffle of the self caches, window-local parents; the
    # slice's shape first (5 lanes, whole slabs, as the bf16 main path),
    # then 8 windows, then the prefix mode of the int8 path with two
    # rank-4 caches and two rank-3 per-row arrays. Bit-exact.
    for w, valid in ((1, None), (8, None), (1, 37), (1, 128)):
        b = 5 * w
        arrays = [_randn((b, 32, 128, d), gen) for _ in range(2)]
        if valid is not None:
            arrays += [_randn((b, 32, 128), gen, dtype=f32) for _ in range(2)]
        par = (torch.randint(0, 5, (b,), generator=gen, device="cuda")
               + torch.arange(w, device="cuda").repeat_interleave(5) * 5
               ).to(torch.int32)
        out_k = [torch.zeros_like(a) for a in arrays]
        out_p = [torch.zeros_like(a) for a in arrays]
        copied = sum(
            a.numel() * a.element_size() if valid is None or a.dim() < 4
            else a.shape[0] * a.shape[1] * -(-valid // 32) * 32 * d
            * a.element_size() for a in arrays)
        # the least traffic: each distinct parent's slab read once, every
        # lane's slab written once
        least = (len(set(par.tolist())) + b) * copied // b
        idx = par.long()
        record("permute",
               f"{len(arrays)} arrays B={b} (W={w}) L=32 C=128 d={d}"
               + (f" valid_len={valid}" if valid else " whole slabs"),
               lambda: KP.permute_lanes_arrays(arrays, par, out_k,
                                               valid_len=valid),
               lambda: KP.permute_lanes_arrays_plain(arrays, par, out_p,
                                                     valid_len=valid),
               0.0, 0.0, (least, 0),
               None if valid else lambda: [
                   torch.index_select(a, 0, idx, out=o)
                   for a, o in zip(arrays, out_p)])
        del arrays, out_k, out_p
    # G: K6 / K7 (W8A8) at the shapes of the w8a8 slice: decode steps of
    # 1, 5 and 20 rows (greedy, one window's beam, 4 windows' beam) at the
    # decoder's four weight shapes (qkv; attn_o, cross_q, cross_o; mlp1;
    # mlp2), a tail window's encoder (750 rows: K6) and the batched encoder
    # (4 x 750 rows: K7) at the same four shapes, and a ragged M. Above 64
    # rows (the large-M route) each row also times a bf16 `torch.mm` of
    # the same (M, K, N) as mm_bf16_ms (int8 has twice bf16's peak). Each x
    # of more than two rows has a zero row and a row of exact half
    # quantization steps; at M=1 the row is a normal one. Tolerance 0:
    # bit-equal. library: `torch._int_mm` of the pre-quantized int8 x (the
    # integer GEMM alone, where its shape rules allow: M > 16); dequant:
    # `_matmul` with int8_impl="xla" (the int8 -> bf16 weight conversion
    # inside the matmul), the path K6/K7 replace.
    from whisper_tpu_torch.ops.kernels import dequant_matmul as KQ
    from whisper_tpu_torch.quantize import QTensor

    def int_mm(xq, wq):
        """The yardstick call, or None (logged) where this PyTorch build
        refuses the shapes."""
        try:
            torch._int_mm(xq, wq)
        except RuntimeError as e:
            log(f"torch._int_mm refuses {tuple(xq.shape)} x "
                f"{tuple(wq.shape)}: {e}")
            return None
        return lambda: torch._int_mm(xq, wq)

    decode_shapes = ((d, 3 * d), (d, d), (d, hidden), (hidden, d))
    for name, m, k_in, n_out in (
            *[("quantized_matmul", m, k_in, n_out) for m in (1, 5, 20)
              for k_in, n_out in decode_shapes],
            *[("quantized_matmul", 750, k_in, n_out)
              for k_in, n_out in decode_shapes],
            ("quantized_matmul_big", 3000, d, 3 * d),
            ("quantized_matmul_big", 3000, d, d),
            ("quantized_matmul_big", 3000, d, hidden),
            ("quantized_matmul_big", 3000, hidden, d),
            ("quantized_matmul_big", 1537, d, 3 * d),
            # packed int4 weights (K, N / 2): the int4 agreement slice's
            # greedy and beam steps at the four weight shapes, an MLP-out
            # step of 20 rows, a tail window's encoder, its
            # two-window batched encoder (1500 rows: a tail tile of 92),
            # and the int8 rows' 3000 (a tail of 56). No PyTorch call takes
            # int4 weights.
            *[("quantized_matmul_int4", m, k_in, n_out) for m in (1, 5)
              for k_in, n_out in decode_shapes],
            ("quantized_matmul_int4", 20, hidden, d),
            ("quantized_matmul_int4", 750, d, 3 * d),
            ("quantized_matmul_big_int4", 1500, d, 3 * d),
            ("quantized_matmul_big_int4", 1500, hidden, d),
            ("quantized_matmul_big_int4", 3000, d, 3 * d),
            ("quantized_matmul_big_int4", 3000, hidden, d)):
        x = _randn((m, k_in), gen)
        if m > 2:  # at one row, a zero row would make any kernel's output 0
            x[0] = 0
            x[1] = 0
            x[1, 0] = 127
            x[1, 1:41] = torch.arange(40, device="cuda") + 0.5
        int4 = name.endswith("_int4")
        big = name.startswith("quantized_matmul_big")
        lim = 7 if int4 else 127
        wq = torch.randint(-lim, lim + 1, (k_in, n_out), generator=gen,
                           device="cuda", dtype=torch.int8)
        xq = KQ.quantize_rows_plain(x, big)[0]
        library = int_mm(xq, wq) if m > 16 and not int4 else None
        if int4:
            wq = pack_int4(wq)
        ws = 0.001 + 0.01 * torch.rand(n_out, generator=gen, device="cuda")
        kern = KQ.quantized_matmul_big if big else KQ.quantized_matmul
        plain = (KQ.quantized_matmul_big_plain if big
                 else KQ.quantized_matmul_plain)
        qt = QTensor(wq, ws)
        # the large-M route's yardstick: a bf16 GEMM of the same shape
        yard = {}
        if m > KQ.SMALL_M:
            w16 = _randn((k_in, n_out), gen)
            yard["mm_bf16_ms"] = lambda: torch.mm(x, w16)
        record(name, f"M={m} K={k_in} N={n_out}",
               lambda: kern(x, wq, ws), lambda: plain(x, wq, ws), 0.0, 0.0,
               (m * k_in * 2 + wq.numel() + n_out * 4 + m * n_out * 2,
                2 * m * k_in * n_out),
               library, dtype=torch.int8,
               dequant_ms=lambda: M._matmul(x, qt, "xla"), **yard)
        del x, wq, xq, qt, library, yard
    for name, rs in rows.items():
        for r in rs:
            lib = ("none" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f} ms")
            deq = (f" dequant path {r['dequant_ms']:.4f} ms"
                   if "dequant_ms" in r else "")
            if "mm_bf16_ms" in r:
                deq += f" bf16 mm {r['mm_bf16_ms']:.4f} ms"
            if "composed_ms" in r:
                deq += f" composed {r['composed_ms']:.4f} ms"
            log(f"kernel {name} [{r['shape']}]: max_abs_err {r['max_abs_err']:.3g}"
                f" (atol {r['atol']}, rtol {r['rtol']}; worst err/tol "
                f"{r['err_over_tol']:.3f}) kernel {r['ms']:.4f} ms"
                f" plain {r['plain_ms']:.4f} ms library {lib}{deq}"
                f" bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    for name in REDESIGNED:
        parts = []
        for r in rows[name]:  # read only: the rows feed the kernels line
            first = FIRST_VERSION_MS.get((name, r["shape"]))
            lib = r["library_ms"]
            parts.append(
                f"[{r['shape']}] {r['ms']:.4f} ms = "
                + ("(no first-version time)" if first is None
                   else f"{r['ms'] / first:.3f} x the first version's "
                        f"{first:.4f}")
                + ("" if lib is None
                   else f", {r['ms'] / lib:.2f} x the library call's "
                        f"{lib:.4f}")
                + ("" if "composed_ms" not in r
                   else f", {r['ms'] / r['composed_ms']:.2f} x the composed "
                        f"path's {r['composed_ms']:.4f}")
                + ("" if "mm_bf16_ms" not in r
                   else f", {r['ms'] / r['mm_bf16_ms']:.2f} x a bf16 "
                        f"torch.mm's {r['mm_bf16_ms']:.4f}"))
        log(f"redesigned {name}: " + "; ".join(parts))
    return rows


# (name, id, CUDA source, the TPU kernel it replaces); the ids are
# PERF.md's. The *_int4 entries are the same kernels instantiated for
# packed-int4 storage (self cache or weights), counted apart.
KERNELS = [
    ("flash_attention", "K1", "whisper_tpu_torch/csrc/flash_attention.cu",
     "whisper_tpu/ops/pallas/flash_attention.py:134"),
    ("encoder_mlp", "K2", "whisper_tpu_torch/csrc/encoder_mlp.cu",
     "whisper_tpu/ops/pallas/encoder_block.py:61"),
    ("decode_attention", "K3", "whisper_tpu_torch/csrc/decode_attention.cu",
     "whisper_tpu/ops/pallas/decode_attention.py:481"),
    ("decode_attention_group", "K3g",
     "whisper_tpu_torch/csrc/decode_attention.cu",
     "whisper_tpu/ops/pallas/decode_attention.py:417"),
    ("permute", "K4", "whisper_tpu_torch/csrc/permute.cu",
     "whisper_tpu/ops/pallas/permute.py:96"),
    ("decode_attention_scaled", "K3s",
     "whisper_tpu_torch/csrc/decode_attention.cu",
     "whisper_tpu/ops/pallas/decode_attention.py:445"),
    ("permute_attention", "K5", "whisper_tpu_torch/csrc/permute_attention.cu",
     "whisper_tpu/ops/pallas/permute_attention.py:48"),
    ("quantized_matmul", "K6", "whisper_tpu_torch/csrc/dequant_matmul.cu",
     "whisper_tpu/ops/pallas/dequant_matmul.py:36"),
    ("quantized_matmul_big", "K7", "whisper_tpu_torch/csrc/dequant_matmul.cu",
     "whisper_tpu/ops/pallas/dequant_matmul.py:160"),
    ("decode_attention_flat", "K8", "whisper_tpu_torch/csrc/decode_attention.cu",
     "whisper_tpu/ops/pallas/decode_attention.py:239"),
    ("flash_attention_legacy", "K9", "whisper_tpu_torch/csrc/flash_attention.cu",
     "whisper_tpu/ops/pallas/flash_attention.py:39"),
    ("decode_attention_scaled_int4", "K3s_int4",
     "whisper_tpu_torch/csrc/decode_attention.cu",
     "whisper_tpu/ops/pallas/decode_attention.py:445"),
    ("permute_attention_int4", "K5_int4",
     "whisper_tpu_torch/csrc/permute_attention.cu",
     "whisper_tpu/ops/pallas/permute_attention.py:48"),
    ("quantized_matmul_int4", "K6_int4",
     "whisper_tpu_torch/csrc/dequant_matmul.cu",
     "whisper_tpu/ops/pallas/dequant_matmul.py:36"),
    ("quantized_matmul_big_int4", "K7_int4",
     "whisper_tpu_torch/csrc/dequant_matmul.cu",
     "whisper_tpu/ops/pallas/dequant_matmul.py:160"),
]
# The kernels no default path of the JAX package runs, with the line that
# says why: they are driven at their call sites (phase_sites), not by a
# slice.
SITE_KERNELS = {
    "decode_attention_flat": "whisper_tpu/models/whisper.py:1012-1019 "
                             "(decoder_step sends every S=1 flash step to "
                             "the fused path before _cached_attention:696)",
    "flash_attention_legacy": "whisper_tpu/ops/pallas/flash_attention.py:353 "
                              "(only under WHISPER_TPU_FLASH_IMPL=legacy)",
}


def _counters() -> dict:
    """KERNELS name -> (wrapper, attribute) of its launch counter."""
    from whisper_tpu_torch.ops.kernels import decode_attention as KC
    from whisper_tpu_torch.ops.kernels import dequant_matmul as KQ
    from whisper_tpu_torch.ops.kernels import encoder_block as KB
    from whisper_tpu_torch.ops.kernels import flash_attention as KA
    from whisper_tpu_torch.ops.kernels import permute as KP
    from whisper_tpu_torch.ops.kernels import permute_attention as KF

    return {"flash_attention": (KA.attention_bhsd, "launches"),
            "encoder_mlp": (KB.fused_mlp_block, "launches"),
            "decode_attention": (KC.decode_attention_stacked, "launches"),
            # the part of K3's launches over a layer-major cross cache (the
            # rest read a self cache); not a kernel of its own
            "decode_attention_cross": (KC.decode_attention_stacked,
                                       "cross_launches"),
            "decode_attention_group": (KC.decode_attention_stacked,
                                       "group_launches"),
            # the part of K6's launches (int8 and int4) above 64 rows, on
            # the large-M route; not a kernel of its own
            "quantized_matmul_tiles": (KQ.quantized_matmul, "tile_launches"),
            "permute": (KP.permute_lanes_arrays, "launches"),
            "decode_attention_scaled": (KC.decode_attention_stacked,
                                        "scaled_launches"),
            "permute_attention": (KF.decode_attention_permute_fused,
                                  "launches"),
            "quantized_matmul": (KQ.quantized_matmul, "launches"),
            "quantized_matmul_big": (KQ.quantized_matmul_big, "launches"),
            "decode_attention_flat": (KC.decode_attention, "flat_launches"),
            "flash_attention_legacy": (KA.flash_attention, "launches"),
            "decode_attention_scaled_int4": (KC.decode_attention_stacked,
                                             "scaled_int4_launches"),
            "permute_attention_int4": (KF.decode_attention_permute_fused,
                                       "int4_launches"),
            "quantized_matmul_int4": (KQ.quantized_matmul, "int4_launches"),
            "quantized_matmul_big_int4": (KQ.quantized_matmul_big,
                                          "int4_launches")}


def launch_counts() -> dict:
    return {n: getattr(fn, a) for n, (fn, a) in _counters().items()}


def reset_counts() -> None:
    for fn, a in _counters().values():
        setattr(fn, a, 0)


def timed(label: str, fn, *args):
    """fn(*args), with the phase's seconds printed."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"phase {label}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    device = timed("device", phase_device)
    timed("build", phase_build)
    rows = timed("kernels", phase_kernels)
    setup = timed("slice setup", slice_setup)
    slices = {"greedy": timed("greedy", phase_greedy, *setup),
              "beam": timed("beam", phase_beam, *setup)}
    text = {s: slices[s].pop("text") for s in slices}
    slices["beam"]["same_text_as_greedy"] = text["beam"] == text["greedy"]
    log(f"beam text == greedy text: {slices['beam']['same_text_as_greedy']}")
    quant = timed("quantized setup", quant_setup, *setup)
    slices["quant_greedy"] = timed("quantized greedy", phase_quant_greedy,
                                   *quant)
    slices["quant_beam"] = timed("quantized beam", phase_quant_beam, *quant)
    del quant
    for s, bf16 in (("quant_greedy", "greedy"), ("quant_beam", "beam")):
        slices[s]["same_text_as_bf16"] = slices[s].pop("text") == text[bf16]
        log(f"{s} text == {bf16} text: {slices[s]['same_text_as_bf16']}")
    params, tr, wave = setup
    waves = [wave, synthetic_speech(35 * 16000, SEED + 1)]
    slices["batched_greedy"] = timed(
        "batched greedy", phase_batched_greedy, tr, waves, text["greedy"])
    slices["w8a8_batched_beam"] = timed(
        "w8a8 batched beam", phase_w8a8_batched_beam,
        *w8a8_setup(params, tr), waves)
    sites = timed("sites", phase_sites, params, tr, wave)
    slices["timestamps_ladder"] = timed("timestamps + ladder",
                                        phase_timestamps_ladder, tr, wave)
    forced = timed("forced branches", phase_forced_branches, params, tr,
                   waves)
    slices["int4_agreement"] = timed("int4 agreement",
                                     phase_int4_agreement, params, tr, wave)
    slices["batched_timestamps_ladder"] = timed(
        "batched timestamps + ladder", phase_batched_timestamps, tr, waves)
    slices["words"] = timed("words", phase_words, params, tr, wave)
    slices["waveform_to_text"] = timed(
        "waveform_to_text", phase_waveform_to_text, tr, wave, text["greedy"])
    slices["speculative"] = timed(
        "speculative", phase_speculative, params, tr, wave,
        dict(slices["greedy"], text=text["greedy"]))
    slices["streaming"] = timed("streaming", phase_streaming, tr, waves)
    slices["serve"] = timed("serve", phase_serve, tr, waves)
    # every kernel must run on some slice's main path, K8 and K9 at their
    # call sites
    launches = {n: sum(sl["launches"][n] for sl in slices.values())
                for n, *_ in KERNELS}
    for n in SITE_KERNELS:
        if launches[n]:
            raise AssertionError(f"a slice launched {n} ({launches[n]}), "
                                 "which no default path runs")
        launches[n] = sites["launches"][n]
    missing = [n for n, count in launches.items() if count == 0]
    if missing:
        raise AssertionError(f"kernels no slice or site check launched: "
                             f"{missing}")
    k3_cross = sum(sl["launches"]["decode_attention_cross"]
                   for sl in slices.values())
    log(f"K3 launches: {launches['decode_attention'] - k3_cross} over self "
        f"caches, {k3_cross} over cross caches")
    k6_tiles = sum(sl["launches"]["quantized_matmul_tiles"]
                   for sl in slices.values())
    k6_all = launches["quantized_matmul"] + launches["quantized_matmul_int4"]
    log(f"K6 launches (int8 and int4): {k6_all - k6_tiles} at decode rows, "
        f"{k6_tiles} on the large-M route")
    entries = []
    for name, kid, source, replaces in KERNELS:
        first = rows[name][0]
        site = name in SITE_KERNELS
        entries.append({
            "name": name, "id": kid, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "path": "site" if site else "slice",
            **({"why_site": SITE_KERNELS[name]} if site else {}),
            "launches_by_slice": {s: sl["launches"][name]
                                  for s, sl in slices.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first["library_ms"],
            "shape": first["shape"], "all_shapes": rows[name],
        })
        if "dequant_ms" in first:
            entries[-1]["dequant_ms"] = first["dequant_ms"]
        if "composed_ms" in first:
            entries[-1]["composed_ms"] = first["composed_ms"]
        if name == "decode_attention":
            entries[-1]["launches_cross"] = k3_cross
        if name == "quantized_matmul":
            entries[-1]["launches_tiles"] = k6_tiles
    log(json.dumps({"kernels": entries, **slices, "sites": sites,
                    "forced_branches": forced}))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


def phase_sites(params, tr, wave) -> dict:
    """K9 and K8 where the JAX package dispatches them, with the launch
    counts set to 0 just before and read just after.

    K9: one window's encoder with KernelKnobs(flash_impl="legacy") (one K9
    launch a layer) against the default K1 encoder and the plain encoder,
    relative L2 within PATH_RTOL. K8: a greedy prefill of the first window
    plus 16 greedy steps, then for layers 0, 15 and 31 the next token's
    query through `_cached_attention(..., impl="flash")` at S = 1 against
    impl="xla", on the self cache (a layer sliced out of the stacked
    buffer) and on the window's bf16, int8 and int4 cross caches, within
    K3's tolerance."""
    import dataclasses

    import whisper_tpu_torch.models.whisper as M
    from whisper_tpu_torch.config import KernelKnobs
    from whisper_tpu_torch.ops.kernels import decode_attention as KC
    from whisper_tpu_torch.pipeline.transcribe import DecodeOptions

    cfg, dev = tr.cfg, tr.device
    opts = DecodeOptions(strategy="greedy")
    window = _full_windows([wave], cfg, opts)[:1]
    legacy = dataclasses.replace(cfg, knobs=KernelKnobs(flash_impl="legacy"))
    dec_cfg = cfg.text_decoder_config
    n_head, eps = dec_cfg.n_text_head, cfg.ln_eps
    res = {}
    with torch.inference_mode():
        mel = _window_mel(window, cfg, opts, dev)
        reset_counts()
        enc = {c: M.encoder_forward(params, mel, cc) for c, cc in (
            ("legacy", legacy), ("bsd", cfg),
            ("plain", dataclasses.replace(cfg, attention="xla")))}
        torch.cuda.synchronize()
        k9 = launch_counts()["flash_attention_legacy"]
        for c in ("legacy", "bsd"):
            if not bool(torch.isfinite(enc[c]).all()):
                raise AssertionError(f"{c} encoder output is not finite")
        res["legacy_vs_bsd_encoder"] = rel_err(enc["legacy"], enc["bsd"])
        res["legacy_vs_plain_encoder"] = rel_err(enc["legacy"], enc["plain"])
        if k9 != cfg.audio_encoder_config.n_audio_layer:
            raise AssertionError(f"legacy encoder: {k9} K9 launches, "
                                 f"expected one a layer")

        prompt = torch.tensor([tr.tok.prompt_ids("en")], device=dev)
        cache = M.init_cache(params, enc["bsd"], cfg, cache_len=128)
        logits, _ = M.decoder_step(params, prompt, 0, cache, cfg)
        pos = prompt.shape[1]
        for _ in range(16):
            nxt = logits[:, -1].argmax(-1)[:, None]
            logits, _ = M.decoder_step(params, nxt, pos, cache, cfg)
            pos += 1
        nxt = logits[:, -1].argmax(-1)[:, None]
        crosses = {"bf16": (cache.cross_k, cache.cross_v)}
        for kv in ("int8", "int4"):
            qc = M.init_cache(params, enc["bsd"], cfg, cache_len=8,
                              kv_quant=kv)
            crosses[kv] = (qc.cross_k, qc.cross_v)
        dec = params["decoder"]
        blocks = list(dec["blocks"].layers())
        sa = enc["bsd"].shape[1]
        errs = {}
        reset_counts()
        for l in (0, len(blocks) // 2 - 1, len(blocks) - 1):
            p = blocks[l]
            h = M._embed(dec, nxt, pos)
            q = M._qkv_proj(M.layer_norm(h, p["attn_ln_g"], p["attn_ln_b"],
                                         eps), p["qkv_w"], p["qkv_b"])[0]
            cases = {"self": (q, cache.self_k[:, l], cache.self_v[:, l],
                              pos - 1)}
            qx = M._linear(M.layer_norm(h, p["cross_ln_g"], p["cross_ln_b"],
                                        eps), p["cross_q_w"], p["cross_q_b"])
            for kv, (ck, cv) in crosses.items():
                layer = (lambda t: M.QTensor(t.q[l], t.scale[l])
                         if isinstance(t, M.QTensor) else t[l])
                cases[f"cross {kv}"] = (qx, layer(ck), layer(cv), sa - 1)
            for name, (qq, kc, vc, last) in cases.items():
                vis = torch.tensor([last], device=dev)
                got = M._cached_attention(qq, kc, vc, vis, n_head, "flash")
                want = M._cached_attention(qq, kc, vc, vis, n_head, "xla")
                err, _ = compare(f"K8 at its site [{name} layer {l}]", got,
                                 want, *KC.TOL[torch.bfloat16])
                errs[name] = max(errs.get(name, 0.0), err)
        torch.cuda.synchronize()
        counts = launch_counts()
    k8 = counts["decode_attention_flat"]
    if k8 != 3 * 4 or any(counts[n] for n in counts
                          if n != "decode_attention_flat"):
        raise AssertionError(f"K8 site check launched {counts}, expected 12 "
                             "K8 launches and nothing else")
    res["k8_max_abs_err"] = errs
    log(f"sites: K9 legacy encoder ({k9} launches) vs K1 encoder "
        f"{res['legacy_vs_bsd_encoder']:.4g}, vs plain encoder "
        f"{res['legacy_vs_plain_encoder']:.4g} (relative L2, limit "
        f"{PATH_RTOL}); K8 at _cached_attention ({k8} launches) max abs err "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    bad = {k: v for k, v in res.items()
           if k.endswith("encoder") and not v <= PATH_RTOL}
    if bad:
        raise AssertionError(f"legacy encoder disagrees: {bad}")
    return dict(res, launches={"flash_attention_legacy": k9,
                               "decode_attention_flat": k8})


def phase_timestamps_ladder(tr, wave) -> dict:
    """Language detection, then timestamped beam 5 with the temperature
    ladder and the no-speech gate over 3 windows, cold and warm."""
    from whisper_tpu_torch.pipeline.transcribe import DecodeOptions

    sr = 16000
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    code, dist = tr.detect_language(wave, sr)
    torch.cuda.synchronize()
    detect_s = time.perf_counter() - t0
    log(f"timestamps slice: detect_language -> {code} (p={dist[code]:.4f}) "
        f"in {detect_s:.3f} s")
    opts = DecodeOptions(temperature=(0.0, 0.2, 0.4), no_speech_threshold=0.6)
    if opts.strategy != "beam" or opts.beam_size != 5:
        raise AssertionError(f"default options are not beam 5: {opts}")
    ladder = tr._decode_window_ladder
    runs = []
    for run in ("cold", "warm"):
        accepted = []

        def spy(*a, accepted=accepted, **kw):
            out = ladder(*a, **kw)
            accepted.append(out[1])
            return out

        tr._decode_window_ladder = spy
        try:
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            text, segs = tr.transcribe_with_timestamps(wave, sr, opts)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            counts = launch_counts()
        finally:
            del tr._decode_window_ladder
        seg_list = [(s.start, s.end, s.text) for s in segs]
        if run == "cold":
            launches, cold = counts, seg_list
        elif seg_list != cold:
            raise AssertionError("timestamps slice: the warm run's segments "
                                 "differ from the cold run's")
        runs.append(dict(run=run, seconds=total, xrt=len(wave) / sr / total,
                         accepted_temperature=accepted,
                         n_segments=len(segs)))
        log(f"timestamps slice {run}: {len(wave) / sr:.1f} s audio, "
            f"{len(accepted)} windows accepted at temperatures {accepted}, "
            f"{len(segs)} segments"
            + (f" from {segs[0].start:.2f}-{segs[0].end:.2f} s to "
               f"{segs[-1].start:.2f}-{segs[-1].end:.2f} s" if segs else "")
            + f" in {total:.3f} s = {len(wave) / sr / total:.2f}x real time")
    log(f"timestamps slice launches: {launches}")
    if len(runs[0]["accepted_temperature"]) != 3:
        raise AssertionError(f"timestamps slice: expected 3 windows, got "
                             f"{runs[0]['accepted_temperature']}")
    if not cold:
        raise AssertionError("timestamps slice: no segment")
    starts = [s for s, _, _ in cold]
    if (starts != sorted(starts)
            or not all(0.0 <= s <= e <= 35.0 for s, e, _ in cold)):
        raise AssertionError(f"timestamps slice: segment times not monotone "
                             f"in [0, 35] s: {[(s, e) for s, e, _ in cold]}")
    for name in ("flash_attention", "encoder_mlp", "decode_attention",
                 "decode_attention_group", "permute"):
        if launches[name] == 0:
            raise AssertionError(f"timestamps slice never launched {name}")
    return dict(launches=launches, runs=runs, language=code,
                language_p=dist[code], detect_seconds=detect_s,
                segments=[dict(start=s, end=e, chars=len(t))
                          for s, e, t in cold])


def _check_segment_times(label: str, segs, audio_s: float) -> None:
    starts = [s.start for s in segs]
    if (starts != sorted(starts)
            or not all(0.0 <= s.start <= s.end <= audio_s for s in segs)):
        raise AssertionError(f"{label}: segment times not monotone in "
                             f"[0, {audio_s}] s: "
                             f"{[(s.start, s.end) for s in segs]}")


def phase_batched_timestamps(tr, waves) -> dict:
    """`transcribe_many_with_timestamps` over the two streams in batches of
    4 windows with beam 5, the ladder and the no-speech gate, cold and
    warm; the launch counts are set to 0 just before the cold run and read
    just after it."""
    from whisper_tpu_torch.pipeline.batch import BatchTranscriber
    from whisper_tpu_torch.pipeline.transcribe import DecodeOptions

    sr = 16000
    opts = DecodeOptions(temperature=(0.0, 0.2, 0.4), no_speech_threshold=0.6)
    if opts.strategy != "beam" or opts.beam_size != 5:
        raise AssertionError(f"default options are not beam 5: {opts}")
    bt = BatchTranscriber(tr.params, tr.cfg, tr.tok, batch_size=4)
    full = _full_windows(waves, tr.cfg, opts)
    audio_s = sum(len(w) for w in waves) / sr
    runs = []
    for run in ("cold", "warm"):
        passes, decoded = [], {}

        def batch_spy(rows, *a, passes=passes, **kw):
            # (prompt, sup_len, opt, timestamps, max_ts_idx, quality, T, gen)
            ids = sorted({i for row in rows for i, w in enumerate(full)
                          if np.array_equal(row, w)})
            passes.append((a[6], ids))
            return BatchTranscriber._decode_batch(bt, rows, *a, **kw)

        def windows_spy(*a, decoded=decoded, **kw):
            out = BatchTranscriber._decode_windows(bt, *a, **kw)
            decoded["results"], decoded["meta"] = out[0], out[1]
            return out

        def ladder_spy(i, *a, decoded=decoded, **kw):
            out = BatchTranscriber._decode_window_ladder(bt, i, *a, **kw)
            decoded.setdefault("tails", {})[i] = out[1]
            return out

        bt._decode_batch, bt._decode_windows = batch_spy, windows_spy
        bt._decode_window_ladder = ladder_spy
        try:
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = bt.transcribe_many_with_timestamps(waves, sr, opts)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            counts = launch_counts()
        finally:
            del bt._decode_batch, bt._decode_windows, bt._decode_window_ladder
        segs = [[(s.start, s.end, s.text) for s in segs] for _, segs in res]
        if run == "cold":
            launches, cold, cold_segs = counts, segs, [x[1] for x in res]
        elif segs != cold:
            raise AssertionError("batched timestamps slice: the warm run's "
                                 "segments differ from the cold run's")
        # the temperatures each full window decoded at; tails: accepted T
        rungs = {i: [t for t, ids in passes if i in ids]
                 for i in range(len(full))}
        per_pass = {}
        for t, ids in passes:
            per_pass[t] = per_pass.get(t, 0) + len(ids)
        results = decoded["results"]
        silent = sorted(k for k, v in results.items() if v == [])
        runs.append(dict(run=run, seconds=total, xrt=audio_s / total,
                         full_window_rungs=rungs,
                         tail_accepted_temperature=decoded.get("tails", {}),
                         windows_per_pass=per_pass, silent_windows=silent,
                         n_segments=[len(s) for s in segs]))
        log(f"batched timestamps slice {run}: {len(waves)} streams, "
            f"{audio_s:.1f} s audio, {len(results)} windows ({len(full)} "
            f"full), windows decoded per batched pass by temperature "
            f"{per_pass}, full windows' temperatures {rungs}, tails "
            f"accepted at {decoded.get('tails', {})}, silence {silent}, "
            f"{[len(s) for s in segs]} segments in {total:.3f} s = "
            f"{audio_s / total:.2f}x real time (batch {bt.batch_size})")
        temps = list(opts.temperature)
        for i, r in rungs.items():
            if not r or r != temps[:len(r)]:
                raise AssertionError(f"full window {i} decoded at {r}, not a "
                                     f"prefix of {temps}")
        if len(results) != len(full) + len(decoded.get("tails", {})):
            raise AssertionError(f"windows without a result: {results}")
    log(f"batched timestamps slice launches: {launches}")
    for stream, segs in enumerate(cold_segs):
        if not segs:
            raise AssertionError(f"batched timestamps slice: stream {stream} "
                                 "has no segment")
        _check_segment_times(f"batched timestamps slice stream {stream}",
                             segs, len(waves[stream]) / sr)
    for name in ("flash_attention", "encoder_mlp", "decode_attention",
                 "decode_attention_group", "permute"):
        if launches[name] == 0:
            raise AssertionError(f"batched timestamps slice never launched "
                                 f"{name}")
    plain = DecodeOptions(temperature=0.0)
    same = [[(s.start, s.end, s.text) for s in
             tr.transcribe_with_timestamps(w, sr, plain)[1]] == c
            for w, c in zip(waves, cold)]
    log(f"batched timestamps segments == transcribe_with_timestamps "
        f"(temperature 0) segments: {same}")
    return dict(launches=launches, runs=runs,
                same_segments_as_sequential_t0=same)


def phase_words(params, tr, wave) -> dict:
    """Greedy timestamped transcription with word timings over the 3
    windows, the launch counts set to 0 just before and read just after;
    then one window's cross-attention weights from the kernel path's
    encoder output against the plain path's."""
    from whisper_tpu_torch.align import cross_attention_weights
    from whisper_tpu_torch.ops import audio
    from whisper_tpu_torch.pipeline.transcribe import DecodeOptions

    sr = 16000
    opts = DecodeOptions(strategy="greedy")
    attach = tr._attach_words
    align_s = []

    def spy(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = attach(*a, **kw)
        torch.cuda.synchronize()
        align_s.append(time.perf_counter() - t0)
        return out

    tr._attach_words = spy
    try:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, segs = tr.transcribe_with_timestamps(wave, sr, opts,
                                                word_timestamps=True)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = launch_counts()
    finally:
        del tr._attach_words
    audio_s = len(wave) / sr
    if not segs:
        raise AssertionError("words slice: no segment")
    _check_segment_times("words slice", segs, audio_s)
    # _attach_words aligns the segments whose start sample clamps to the
    # same window together, and hands the words out in token order: a word
    # that runs on into the next segment's tokens is the earlier one's
    n_window = audio.max_waveform_samples(tr.cfg.encoder_ctx_size
                                          - opts.padding)
    surplus = {}  # window start -> word tokens handed out - text tokens
    for seg in segs:
        w0 = min(int(seg.start * sr), max(0, len(wave) - n_window))
        n_tok = sum(not tr.tok.is_special(t) for t in seg.tokens)
        ahead = surplus.get(w0, 0)
        if seg.text.strip() and not seg.words and ahead <= 0:
            raise AssertionError(f"words slice: segment {seg.start:.2f}-"
                                 f"{seg.end:.2f} s has text and no words")
        surplus[w0] = ahead + sum(len(w.tokens) for w in seg.words) - n_tok
        starts = [w.start for w in seg.words]
        if (starts != sorted(starts) or not all(
                0.0 <= w.start <= w.end <= audio_s for w in seg.words)):
            raise AssertionError(f"words slice: word times not monotone in "
                                 f"[0, {audio_s}] s: "
                                 f"{[(w.start, w.end) for w in seg.words]}")
    n_words = sum(len(s.words) for s in segs)
    if not n_words:
        raise AssertionError("words slice: no word")
    for name in ("flash_attention", "encoder_mlp", "decode_attention"):
        if launches[name] == 0:
            raise AssertionError(f"words slice never launched {name}")
    log(f"words slice: {audio_s:.1f} s audio, {len(segs)} segments, "
        f"{n_words} words in {total:.3f} s: alignment {sum(align_s):.3f} s, "
        f"decode {total - sum(align_s):.3f} s; launches {launches}")

    # the first window's weights, its segments' tokens teacher-forced: from
    # the kernel path's encoder output (K1, K2) and the plain path's
    seq = list(tr.tok.prompt_ids("en", timestamps=True))
    for seg in segs:
        if seg.start * sr < n_window:
            seq += seg.tokens
    seq.append(tr.tok.eot)
    with torch.inference_mode():
        _, enc = _window_encodings(params, tr.cfg, [wave[:n_window]], opts)
        toks = torch.tensor(seq, device=enc["flash"].device)
        w = {a: cross_attention_weights(params, e, toks, tr.cfg)
             for a, e in enc.items()}
    paths = _check_paths("words window cross-attention weights",
                         {"weights": rel_err(w["flash"], w["xla"])},
                         {"weights": w["flash"]})
    return dict(launches=launches, seconds=total,
                align_seconds=sum(align_s), xrt=audio_s / total,
                n_segments=len(segs), n_words=n_words,
                weights_tokens=len(seq), paths=paths)


def phase_waveform_to_text(tr, wave, greedy_text) -> dict:
    """`waveform_to_text` greedy on the card (its own Transcriber over the
    same weights), the launch counts set to 0 just before and read just
    after: the text of the greedy slice."""
    from whisper_tpu_torch.pipeline.transcribe import waveform_to_text

    sr = 16000
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    text, tokens = waveform_to_text(tr.params, tr.cfg, tr.tok, "en", wave,
                                    sr, strategy="greedy")
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = launch_counts()
    log(f"waveform_to_text: {len(wave) / sr:.1f} s audio, {len(tokens)} "
        f"tokens in {total:.3f} s = {len(wave) / sr / total:.2f}x real "
        f"time; launches {launches}")
    if text != greedy_text:
        raise AssertionError("waveform_to_text's text differs from the greedy "
                             "slice's")
    for name in ("flash_attention", "encoder_mlp", "decode_attention"):
        if launches[name] == 0:
            raise AssertionError(f"waveform_to_text never launched {name}")
    return dict(launches=launches, seconds=total,
                xrt=len(wave) / sr / total, n_tokens=len(tokens))


# ----------------------------------------------------------------------
# The serving path: speculative decoding, streaming, the HTTP server.

# Acceptance expected of a draft that is the target itself: its S = 1 steps
# (K3) and the target's S = k verify (f32 einsum attention) round
# differently, so a proposal is rejected only at a near tie.
SELF_DRAFT_ACCEPTANCE = 0.95


class _WidthCounts:
    """Counts K1, K2 and K3 launches by model width (the last dimension of
    the activation each wrapper gets) while active: the three names are
    wrapped where `models/whisper.py` calls them."""

    NAMES = (("flash_attention", "attention_bhsd"),
             ("encoder_mlp", "fused_mlp_block"),
             ("decode_attention", "decode_attention_stacked"))

    def __enter__(self):
        from whisper_tpu_torch.models import whisper as M

        self.M, self.saved, self.counts = M, {}, {}
        for kernel, attr in self.NAMES:
            fn = getattr(M, attr)
            self.saved[attr] = fn

            def spy(x, *a, fn=fn, kernel=kernel, **kw):
                before = fn.launches
                out = fn(x, *a, **kw)
                if fn.launches > before:
                    key = (kernel, int(x.shape[-1]))
                    self.counts[key] = self.counts.get(key, 0) + 1
                return out
            setattr(M, attr, spy)
        return self

    def __exit__(self, *exc):
        for attr, fn in self.saved.items():
            setattr(self.M, attr, fn)

    def by_width(self) -> dict:
        return {f"{k}@d{w}": n for (k, w), n in sorted(self.counts.items())}


def _top2_gap(logits) -> float:
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def _first_divergence(tr, spec_tr, wave, opts) -> None:
    """Report, then raise: the first window whose speculative tokens differ
    from plain greedy's, the first differing position, and the top-2 logit
    gap there on the plain S = 1 path (K3) and on the general path the
    verify step takes, both fed the common prefix."""
    from whisper_tpu_torch.models import whisper as M
    from whisper_tpu_torch.models.whisper import encoder_forward

    prompt, _ = tr._build_prompt(opts)
    sup = opts.suppress_until_len
    for i, _, _, window in tr._windows(wave, 16000, opts):
        with torch.inference_mode():
            plain = tr._decode(window, prompt, sup, opts)[0]
            spec = spec_tr._decode(window, prompt, sup, opts)[0]
            if plain == spec:
                continue
            j = next((n for n, (a, b) in enumerate(zip(plain, spec))
                      if a != b), min(len(plain), len(spec)))
            enc = encoder_forward(tr.params, tr._window_mel(
                window[None, :], opts), tr.cfg)
            toks = torch.tensor([plain[:j]], device="cuda")
            n_prompt = len(prompt)
            cache = M.init_cache(tr.params, enc, tr.cfg, batch=1,
                                 cache_len=448)
            logits, _ = M.decoder_step(tr.params, toks[:, :n_prompt], 0,
                                       cache, tr.cfg)
            for pos in range(n_prompt, j):
                logits, _ = M.decoder_step(tr.params, toks[:, pos:pos + 1],
                                           pos, cache, tr.cfg)
            cache = M.init_cache(tr.params, enc, tr.cfg, batch=1,
                                 cache_len=448)
            general, _ = M.decoder_step(tr.params, toks, 0, cache, tr.cfg)
        log(f"speculative: window {i} differs at position {j} (plain "
            f"{plain[j:j + 3]}, speculative {spec[j:j + 3]}); top-2 logit "
            f"gap there: plain S=1 path {_top2_gap(logits[0, -1]):.5f}, "
            f"general path {_top2_gap(general[0, -1]):.5f}")
        raise AssertionError(f"speculative text differs from greedy's "
                             f"(window {i}, position {j})")
    raise AssertionError("speculative text differs from greedy's, but no "
                         "window's tokens do")


def phase_speculative(params, tr, wave, greedy_info) -> dict:
    """Greedy over the 35 s stream with a multilingual tiny draft (random
    bf16 weights from SEED + 2, draft_k 4), cold and warm: the text of the
    greedy slice, K1, K2 and K3 launched at both widths. Then a self-draft
    (draft = the target's weights) over one window: plain greedy's tokens,
    the acceptance rate, and a draft self cache with every row in
    [P, length - 1) written and within PATH_RTOL of the target's."""
    from whisper_tpu_torch.config import preset
    from whisper_tpu_torch.decode import speculative as S
    from whisper_tpu_torch.decode.greedy import greedy_decode
    from whisper_tpu_torch.models.whisper import encoder_forward
    from whisper_tpu_torch.params import init_params
    from whisper_tpu_torch.pipeline.transcribe import (DecodeOptions,
                                                       Transcriber)

    sr, k = 16000, 4
    opts = DecodeOptions(strategy="greedy", max_depth=100)
    d_cfg = preset("tiny")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    draft = init_params(d_cfg, gen, dtype=torch.bfloat16)
    spec_tr = Transcriber(params, tr.cfg, tr.tok, draft=(draft, d_cfg),
                          draft_k=k)
    runs = []
    for run in ("cold", "warm"):
        S.speculative_greedy_decode.iterations = 0
        S.speculative_greedy_decode.accepted = 0
        reset_counts()
        with _WidthCounts() as widths:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            text, tokens = spec_tr.transcribe(wave, sr, opts,
                                              on_chunk=lambda i, t: None)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
        it = S.speculative_greedy_decode.iterations
        acc = S.speculative_greedy_decode.accepted
        if run == "cold":
            launches, by_width, cold_text = launch_counts(), \
                widths.by_width(), text
        elif text != cold_text:
            raise AssertionError("speculative: the warm run's text differs")
        runs.append(dict(run=run, seconds=total, xrt=len(wave) / sr / total,
                         verify_steps=it, accepted=acc,
                         acceptance=acc / max(it * (k - 1), 1),
                         n_tokens=len(tokens)))
        log(f"speculative {run}: {len(wave) / sr:.1f} s audio, "
            f"{len(tokens)} tokens, {it} verify steps, acceptance "
            f"{runs[-1]['acceptance']:.4f} in {total:.3f} s = "
            f"{len(wave) / sr / total:.2f}x real time (greedy slice "
            + ", ".join(f"{r['run']} {r['seconds']:.3f} s"
                        for r in greedy_info["runs"]) + ")")
    log(f"speculative launches: {launches}; K1/K2/K3 by width: {by_width}")
    if cold_text != greedy_info["text"]:
        _first_divergence(tr, spec_tr, wave, opts)
    for kernel in ("flash_attention", "encoder_mlp"):
        for width in (384, 1280):
            if by_width.get(f"{kernel}@d{width}", 0) == 0:
                raise AssertionError(f"speculative: {kernel} never launched "
                                     f"at d {width}")
    if by_width.get("decode_attention@d384", 0) == 0:
        raise AssertionError("speculative: the draft never launched K3")

    # self-draft over the first window, through the decoder functions
    window = next(tr._windows(wave, sr, opts))[3]
    prompt, _ = tr._build_prompt(opts)
    common = tr._decode_args(opts, opts.suppress_until_len, False, 50,
                             False, 0)
    S.speculative_greedy_decode.iterations = 0
    S.speculative_greedy_decode.accepted = 0
    caches = {}
    with _WidthCounts() as widths, torch.inference_mode():
        enc = encoder_forward(params, tr._window_mel(window[None, :], opts),
                              tr.cfg)
        want = greedy_decode(params, enc, prompt, tr.cfg, **common)
        got = S.speculative_greedy_decode(
            params, enc, prompt, tr.cfg, draft_params=params,
            draft_enc_out=enc, draft_cfg=tr.cfg, n_draft=k,
            caches=caches, **common)
    n = int(got[1][0])
    it = S.speculative_greedy_decode.iterations
    acceptance = S.speculative_greedy_decode.accepted / max(it * (k - 1), 1)
    same = (n == int(want[1][0])
            and torch.equal(got[0][0, :n], want[0][0, :n]))
    p = len(prompt)
    d_rows = caches["draft"].self_k[0, :, p:n - 1].float()
    t_rows = caches["target"].self_k[0, :, p:n - 1].float()
    zero_rows = int((d_rows.abs().amax(dim=(0, 2)) == 0).sum())
    cache_err = rel_err(d_rows, t_rows)
    log(f"self-draft window: {n - p} tokens, {it} verify steps, acceptance "
        f"{acceptance:.4f}, tokens equal to greedy: {same}; draft self "
        f"cache rows [{p}, {n - 1}): {zero_rows} zero, {cache_err:.5f} "
        f"relative L2 from the target's; K3 by width {widths.by_width()}")
    if not same:
        raise AssertionError("self-draft: tokens differ from greedy's")
    if zero_rows or cache_err > PATH_RTOL:
        raise AssertionError(f"self-draft: draft cache has {zero_rows} zero "
                             f"rows, {cache_err} from the target's")
    if acceptance < SELF_DRAFT_ACCEPTANCE:
        raise AssertionError(f"self-draft acceptance {acceptance:.4f} < "
                             f"{SELF_DRAFT_ACCEPTANCE}")
    return dict(launches=launches, launches_by_width=by_width, runs=runs,
                self_draft=dict(tokens=n - p, verify_steps=it,
                                acceptance=acceptance, zero_rows=zero_rows,
                                cache_rel_err=cache_err,
                                launches_by_width=widths.by_width()))


def _push_stream(st, wave, block: int):
    """(segments confirmed by pushes and finish, seconds)."""
    t0 = time.perf_counter()
    segs = []
    for i in range(0, len(wave), block):
        segs.extend(st.push(wave[i:i + block]))
    segs.extend(st.finish())
    torch.cuda.synchronize()
    return segs, time.perf_counter() - t0


def phase_streaming(tr, waves) -> dict:
    """One StreamingTranscriber (beam 5, max_depth 100) over 20 s pushed in
    1 s blocks, a decode every 4 s; then 4 sessions on 4 threads over 10 s
    each, sharing one StreamDecodeBatcher(batch_size=4), against their
    unbatched runs (reported, not asserted). Random weights decode
    repetition loops, which the compression-ratio gate would drop at
    confirmation: the gate is off here, so confirmation itself runs."""
    import threading

    from whisper_tpu_torch.pipeline.batch import BatchTranscriber
    from whisper_tpu_torch.pipeline.streaming import (StreamDecodeBatcher,
                                                      StreamingTranscriber)
    from whisper_tpu_torch.pipeline.transcribe import DecodeOptions

    sr = 16000
    opts = DecodeOptions(max_depth=100, compression_ratio_threshold=None)
    if opts.strategy != "beam" or opts.beam_size != 5:
        raise AssertionError(f"default options are not beam 5: {opts}")
    reset_counts()
    st = StreamingTranscriber(None, None, None, options=opts,
                              min_step_seconds=4.0, transcriber=tr)
    segs, total = _push_stream(st, waves[0][:20 * sr], sr)
    launches = launch_counts()
    _check_segment_times("streaming", segs, 20.0)
    log(f"streaming: 20 s in 1 s blocks, {st.decodes} decodes, "
        f"{len(segs)} segments in {total:.3f} s; text {st.text[:120]!r}")
    if not segs:
        raise AssertionError("streaming: nothing confirmed")

    bt = BatchTranscriber(tr.params, tr.cfg, tr.tok, batch_size=4)
    clips = [w[a * sr:(a + 10) * sr] for w, a in ((waves[0], 0),
                                                 (waves[0], 20),
                                                 (waves[1], 0),
                                                 (waves[1], 20))]
    ref = []
    for clip in clips:
        s = StreamingTranscriber(None, None, None, options=opts,
                                 min_step_seconds=4.0, transcriber=tr)
        ref.append([(x.text, x.tokens) for x in _push_stream(s, clip, sr)[0]])
    batcher = StreamDecodeBatcher(bt, batch_size=4, max_wait_s=1.0,
                                  timeout_s=120.0)
    sessions = [StreamingTranscriber(None, None, None, options=opts,
                                     min_step_seconds=4.0, transcriber=bt,
                                     batcher=batcher) for _ in clips]
    outs, errors = [None] * 4, []

    def run(i):
        try:
            outs[i] = _push_stream(sessions[i], clips[i], sr)[0]
        except Exception as e:  # reported below, fails the phase
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    reset_counts()
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    concurrent_s = time.perf_counter() - t0
    batcher.stop(timeout=10)
    concurrent_launches = launch_counts()
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"streaming sessions failed or hung: {errors}")
    if batcher._thread.is_alive():
        raise AssertionError("streaming: the batcher's thread outlived stop()")
    decodes = sum(s.decodes for s in sessions)
    same = [[(x.text, x.tokens) for x in o] == r for o, r in zip(outs, ref)]
    log(f"streaming x4: {decodes} decodes in {batcher.batches} batches "
        f"({batcher.batched_requests} batched) in {concurrent_s:.3f} s; "
        f"each session equal to its unbatched run: {same}")
    if not batcher.batches < decodes:
        raise AssertionError("streaming x4: no decodes shared a batch")
    for name in ("flash_attention", "encoder_mlp", "decode_attention",
                 "decode_attention_group", "permute"):
        if launches[name] + concurrent_launches[name] == 0:
            raise AssertionError(f"streaming never launched {name}")
    return dict(launches={n: launches[n] + concurrent_launches[n]
                          for n in launches},
                seconds=total, decodes=st.decodes, segments=len(segs),
                sessions=dict(decodes=decodes, batches=batcher.batches,
                              seconds=concurrent_s,
                              same_as_unbatched=same))


def _wav_bytes(wave) -> bytes:
    import io
    import wave as wave_mod

    buf = io.BytesIO()
    with wave_mod.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(wave, -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def _http(url, path, body=None):
    """(status, body bytes, seconds) of one request."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url + path, data=body,
                                 method="GET" if body is None else "POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read(), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, e.read(), time.perf_counter() - t0


def phase_serve(tr, waves) -> dict:
    """The server as the tests build it (a BatchTranscriber of batch 4 on
    the greedy slice's weights, `serve.warm_up`, BatchingWorker,
    make_handler, a threading HTTP server on a free port): 3 concurrent
    greedy requests through the window pool, equal to `transcribe_many`; a
    timestamped SRT request on the grouped path; a /stream session;
    /healthz and /metrics; then both workers stopped and joined. The
    launch counts are read around the requests, with the server quiet on
    both sides."""
    import threading
    from http.server import ThreadingHTTPServer

    from whisper_tpu_torch import serve as SV
    from whisper_tpu_torch.pipeline.batch import BatchTranscriber

    sr = 16000
    bt = BatchTranscriber(tr.params, tr.cfg, tr.tok, batch_size=4)
    warm_s = SV.warm_up(bt)  # what serve() runs before it reports ready
    worker = SV.BatchingWorker(bt, max_batch=4, max_wait_s=0.05)
    streams = SV.StreamSessions(bt, max_sessions=4)
    worker.start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), SV.make_handler(
        worker, sr, request_timeout_s=300.0, streams=streams))
    server_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    server_thread.start()
    url = f"http://127.0.0.1:{httpd.server_port}"
    try:
        audio = [waves[0], waves[1], synthetic_speech(10 * sr, SEED + 3)]
        bodies = [_wav_bytes(w) for w in audio]
        # what the server decodes: the WAV's 16-bit samples
        heard = [np.frombuffer(b[44:], "<i2").astype(np.float32) / 32767.0
                 for b in bodies]
        results = [None] * 3
        reset_counts()

        def call(i):
            results[i] = _http(url, "/transcribe?lang=en&greedy=1", bodies[i])

        threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        pooled_s = time.perf_counter() - t0
        status, srt, srt_s = _http(
            url, "/transcribe?lang=en&greedy=1&timestamps=1&format=srt",
            bodies[2])
        if status != 200 or b"-->" not in srt:
            raise AssertionError(f"serve: SRT request gave {status} {srt!r}")
        code, out, _ = _http(url, "/stream/start?lang=en&greedy=1", b"")
        sid = json.loads(out)["session"]
        s16 = (np.clip(audio[2], -1, 1) * 32767).astype("<i2")
        t0 = time.perf_counter()
        for i in range(0, len(s16), 2 * sr):
            code, out, _ = _http(url, f"/stream/{sid}/push?format=s16",
                                 s16[i:i + 2 * sr].tobytes())
            if code != 200:
                raise AssertionError(f"serve: stream push gave {code}")
        code, out, _ = _http(url, f"/stream/{sid}/finish", b"")
        stream_s = time.perf_counter() - t0
        if code != 200:
            raise AssertionError(f"serve: stream finish gave {code}")
        stream_text = json.loads(out)["text"]
        torch.cuda.synchronize()
        launches = launch_counts()
        health = json.loads(_http(url, "/healthz")[1])
        metrics = {}
        for line in _http(url, "/metrics")[1].decode().splitlines():
            if line and not line.startswith("#"):
                name, val = line.rsplit(" ", 1)
                metrics[name] = float(val)
    finally:
        httpd.shutdown()
        httpd.server_close()
        t0 = time.perf_counter()
        worker.stop(timeout=10)
        streams.stop(timeout=10)
        stop_s = time.perf_counter() - t0
    if worker.is_alive() or (streams.batcher._thread is not None
                             and streams.batcher._thread.is_alive()):
        raise AssertionError("serve: a worker outlived stop()")
    if any(r is None or r[0] != 200 for r in results):
        raise AssertionError(f"serve: pooled requests gave "
                             f"{[r and r[:2] for r in results]}")
    texts = [json.loads(r[1])["text"] for r in results]
    req = SV._Request(np.zeros(1, np.float32), "en", True)
    with torch.inference_mode():
        want = [t for t, _ in bt.transcribe_many(
            heard, options=SV.BatchingWorker._opts(req))]
    latencies = [r[2] for r in results]
    log(f"serve: 3 pooled greedy requests ({[len(w) / sr for w in audio]} s) "
        f"in {pooled_s:.3f} s, latencies "
        + ", ".join(f"{x:.3f}" for x in latencies)
        + f" s; SRT {srt_s:.3f} s; stream 10 s in 2 s blocks {stream_s:.3f} "
        f"s ({stream_text!r}); healthz {health}; batches_total "
        f"{metrics['whisper_batches_total']:.0f}; stopped in {stop_s:.3f} s; "
        f"warm-up {warm_s:.3f} s")
    log(f"serve launches: {launches}")
    if texts != want:
        raise AssertionError("serve: pooled texts differ from transcribe_many's")
    if metrics["whisper_batches_total"] < 1 or health["status"] != "ok":
        raise AssertionError(f"serve: metrics {metrics}, health {health}")
    if stop_s > 10.0:
        raise AssertionError(f"serve: stop and join took {stop_s:.1f} s")
    for name in ("flash_attention", "encoder_mlp", "decode_attention"):
        if launches[name] == 0:
            raise AssertionError(f"serve never launched {name}")
    return dict(launches=launches, pooled_seconds=pooled_s,
                latencies=latencies, srt_seconds=srt_s,
                stream_seconds=stream_s, stop_seconds=stop_s,
                warm_up_seconds=warm_s,
                batches_total=metrics["whisper_batches_total"])


def _forcing_hook(n_prompt: int, eot_id: int, eot_at=None):
    """A logits_hook that fixes the tokens: at depth t (tokens after the
    prompt) it adds 1e4 to text token 300 + 7 t, or to EOT once t reaches
    eot_at(rows)[row]. Both paths then emit the same tokens whatever their
    logits, each with log-prob 0 in f32 (the others' exp underflows)."""

    def hook(x, tokens, seq_len):
        depth = seq_len - n_prompt
        rows = x.shape[0]
        want = torch.full((rows,), 300 + 7 * depth, dtype=torch.long,
                          device=x.device)
        if eot_at is not None:
            at = torch.tensor(eot_at(rows), device=x.device)
            want = torch.where(at <= depth, eot_id, want)
        return x.scatter_add(1, want[:, None],
                             torch.full((rows, 1), 1e4, device=x.device))

    return hook


def _flat_hook(n_prompt: int, eot_id: int):
    """A logits_hook that makes every allowed token equally likely: the
    average log-prob is -log(allowed tokens), far below -1."""

    def hook(x, tokens, seq_len):
        return torch.where(torch.isfinite(x), torch.zeros_like(x), x)

    return hook


class _Hooked:
    """Within `with`, the pipeline's decoders run with `make(n_prompt,
    eot_id)` as their logits_hook (the pipeline itself takes none)."""

    NAMES = (("transcribe", "beam_search"), ("transcribe", "greedy_decode"),
             ("batch", "greedy_decode"), ("batch", "beam_search_batched"))

    def __init__(self, make, eot_id: int):
        import importlib

        self.mods = {m: importlib.import_module(
            f"whisper_tpu_torch.pipeline.{m}") for m in ("transcribe", "batch")}
        self.make, self.eot_id = make, eot_id
        self.saved = {}

    def __enter__(self):
        for m, name in self.NAMES:
            fn = getattr(self.mods[m], name)
            self.saved[(m, name)] = fn

            def call(params, enc, prompt, cfg, *a, _fn=fn, **kw):
                kw["logits_hook"] = self.make(int(prompt.shape[0]),
                                              self.eot_id)
                return _fn(params, enc, prompt, cfg, *a, **kw)

            setattr(self.mods[m], name, call)
        return self

    def __exit__(self, *exc):
        for (m, name), fn in self.saved.items():
            setattr(self.mods[m], name, fn)


def phase_forced_branches(params, tr, waves) -> dict:
    """Decode branches random weights never reach, forced by logits hooks
    over large-v2 windows, each run on the kernel path (launch counts read
    around it) and on the plain path (attention="xla"), which must give the
    same tokens:
      rung 0    -- one window, beam 5 with the ladder (0, 0.2, 0.4): forced
                   tokens (log-prob 0) and EOT at depth 10 pass the checks,
                   so the window is accepted at T = 0 after one rung;
      no speech -- one window, the ladder with no_speech_threshold -1: flat
                   logits fail the log-prob check, so the no-speech gate
                   skips the window at rung 0 (the gate reads the raw
                   p(<|nospeech|>), which no hook changes and which random
                   weights can round to 0 in f32, hence a threshold below
                   any probability);
      beam EOT  -- one window, beam 5, EOT forced on lane i from depth
                   3 + 2 i: lanes finish at different steps;
      batch EOT -- `transcribe_many` greedy over the two streams (their 4
                   full windows as one batch, the tails alone), EOT forced
                   on row i from depth 3 + 3 i: rows finish ragged."""
    from whisper_tpu_torch.pipeline.batch import BatchTranscriber
    from whisper_tpu_torch.pipeline.transcribe import (DecodeOptions,
                                                       Transcriber)

    cfg, tok = tr.cfg, tr.tok
    # one full window; no overlap, so transcribe() cuts no second window
    window = _full_windows(waves[:1], cfg, DecodeOptions())[0]
    plain = Transcriber(tr.params, cfg, tok, attention="xla")
    beam_eot = (lambda n, e: _forcing_hook(n, e, lambda rows: [
        3 + 2 * i for i in range(rows)]))
    batch_eot = (lambda n, e: _forcing_hook(n, e, lambda rows: [
        3 + 3 * i for i in range(rows)]))
    cases = {
        "rung 0": (lambda n, e: _forcing_hook(n, e, lambda rows: [10] * rows),
                   DecodeOptions(temperature=(0.0, 0.2, 0.4), max_depth=16,
                                 chunk_overlap_seconds=0.0), [0.0]),
        "no speech": (_flat_hook, DecodeOptions(
            temperature=(0.0, 0.2), no_speech_threshold=-1.0, max_depth=8,
            chunk_overlap_seconds=0.0), [0.0]),
        "beam EOT": (beam_eot, DecodeOptions(max_depth=16,
                                             chunk_overlap_seconds=0.0),
                     None),
    }
    res = {}
    for name, (make, opts, want_temps) in cases.items():
        out = {}
        for path, t in (("kernel", tr), ("plain", plain)):
            accepted, quality = [], []
            ladder = t._decode_window_ladder

            def spy(*a, accepted=accepted, quality=quality, ladder=ladder,
                    **kw):
                got = ladder(*a, **kw)
                accepted.append(got[1])
                quality.append(got[2])
                return got

            t._decode_window_ladder = spy
            try:
                with _Hooked(make, tok.eot), torch.inference_mode():
                    reset_counts()
                    text, toks = t.transcribe(window, 16000, opts,
                                              on_chunk=lambda i, x: None)
                    torch.cuda.synchronize()
                    counts = launch_counts()
            finally:
                del t._decode_window_ladder
            out[path] = (toks, accepted, counts, quality)
        (toks, accepted, counts, quality), ptoks = (out["kernel"],
                                                     out["plain"][0])
        if toks != ptoks:
            raise AssertionError(f"forced {name}: kernel path tokens {toks} "
                                 f"!= plain path tokens {ptoks}")
        if want_temps is not None and accepted != want_temps:
            raise AssertionError(f"forced {name}: accepted at {accepted}, "
                                 f"expected {want_temps}")
        if name == "no speech" and toks:
            raise AssertionError(f"forced no speech: kept tokens {toks}")
        if name != "no speech" and not toks:
            raise AssertionError(f"forced {name}: no tokens")
        launched = {k: v for k, v in counts.items() if v}
        res[name] = dict(n_tokens=len(toks), accepted=accepted,
                         quality=quality, launches=launched)
        log(f"forced {name}: {len(toks)} tokens, accepted at {accepted} "
            f"(avg_logprob, compression, p(nospeech): {quality}), equal on "
            f"both paths; kernel path launches {launched}")
    opts = DecodeOptions(strategy="greedy", max_depth=16)
    texts = {}
    for path, attention in (("kernel", "flash"), ("plain", "xla")):
        bt = BatchTranscriber(tr.params, cfg, tok, batch_size=4,
                              attention=attention)
        with _Hooked(batch_eot, tok.eot):
            reset_counts()
            texts[path] = bt.transcribe_many(waves, 16000, opts)
            torch.cuda.synchronize()
            if path == "kernel":
                counts = launch_counts()
    if texts["kernel"] != texts["plain"]:
        raise AssertionError("forced batch EOT: the kernel and plain paths' "
                             "transcripts differ")
    launched = {k: v for k, v in counts.items() if v}
    res["batch EOT"] = dict(n_tokens=[len(t) for _, t in texts["kernel"]],
                            launches=launched)
    log(f"forced batch EOT: tokens per stream "
        f"{res['batch EOT']['n_tokens']}, equal on both paths; kernel path "
        f"launches {launched}")
    return res


def synthetic_speech(n_samples: int, seed: int) -> np.ndarray:
    """Speech-shaped synthetic audio: tones + amplitude bursts + noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / 16000.0
    x = (0.3 * np.sin(2 * np.pi * 220.0 * t)
         + 0.2 * np.sin(2 * np.pi * 880.0 * t
                        * (1 + 0.3 * np.sin(2 * np.pi * 2.0 * t)))
         + 0.1 * rng.standard_normal(n_samples))
    envelope = 0.5 + 0.5 * np.sign(np.sin(2 * np.pi * 1.3 * t))
    return (x * envelope).astype(np.float32)


def rel_err(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


# Kernel path vs plain path (attention="xla") on the card, both bf16 over
# the full 32 + 32 layers of random weights: the paths round differently
# (flash scales q once by hd^-0.5, the plain path scales q and k by
# (d/h)^-0.25 each in bf16; the fused MLP keeps its bias + GELU in f32), so
# each layer moves activations by about one bf16 step and the differences
# accumulate over depth. Relative L2 error, ||kernel - plain|| / ||plain||.
PATH_RTOL = 5e-2


def slice_setup() -> tuple:
    """Large-v2 bf16 random weights from the seed, its full-scale
    tokenizer, the Transcriber (on the card by default) and 35 s of
    synthetic audio: 3 windows."""
    from whisper_tpu_torch.config import preset
    from whisper_tpu_torch.ops.kernels import _build
    from whisper_tpu_torch.params import init_params
    from whisper_tpu_torch.pipeline.transcribe import Transcriber
    from whisper_tpu_torch.text.tokenizer import (
        WhisperTokenizer, build_full_scale_tokenizer_json)

    cfg = preset("large-v2")
    tok_path = _build.BUILD_DIR / "tokenizer_large_v2.json"
    tok_path.parent.mkdir(parents=True, exist_ok=True)
    build_full_scale_tokenizer_json(str(tok_path))
    tok = WhisperTokenizer(str(tok_path))
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_params(cfg, gen, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"slice: large-v2 bf16 random weights in {time.perf_counter() - t0:.1f} s")
    tr = Transcriber(params, cfg, tok)
    if tr.device.type != "cuda" or tr.cfg.attention != "flash":
        raise AssertionError(f"the Transcriber's defaults gave "
                             f"{tr.device} / {tr.cfg.attention}")
    return params, tr, synthetic_speech(35 * 16000, SEED)


def run_slice(tr, wave, opts, label: str) -> dict:
    """Cold and warm `Transcriber.transcribe` runs; the launch counts of
    each kernel are set to 0 just before the cold run and read just after
    it."""
    from whisper_tpu_torch.ops import audio
    from whisper_tpu_torch.pipeline.transcribe import window_waveform

    sr = 16000
    cfg = tr.cfg
    n_window = audio.max_waveform_samples(cfg.encoder_ctx_size - opts.padding)
    bounds = list(window_waveform(wave, sr, n_window,
                                  int(sr * opts.chunk_overlap_seconds)))
    n_layer = cfg.text_decoder_config.n_text_layer
    runs = []
    for run in ("cold", "warm"):
        stamps = []

        def on_chunk(i, text, stamps=stamps):
            stamps.append((i, time.perf_counter()))

        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        text, tokens = tr.transcribe(wave, sr, opts, on_chunk=on_chunk)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = launch_counts()
        if run == "cold":
            launches = counts
        # an S = 1 step launches two decode attentions a layer: self (K3,
        # K3s or K5) and cross (K3 for greedy, K3g for beam)
        steps = sum(counts[n] for n in (
            "decode_attention", "decode_attention_group",
            "decode_attention_scaled", "permute_attention",
            "decode_attention_scaled_int4",
            "permute_attention_int4")) // (2 * n_layer)
        prev, per_window = t0, []
        for i, ts in stamps:
            start, end = bounds[i]
            per_window.append((end - start) / sr / (ts - prev))
            prev = ts
        runs.append(dict(run=run, seconds=total, xrt=len(wave) / sr / total,
                         window_xrt=per_window, decoder_steps=steps,
                         n_tokens=len(tokens), text_chars=len(text)))
        if run == "cold":
            cold_text = text
        elif text != cold_text:
            raise AssertionError(f"{label}: the warm run's text differs")
        log(f"{label} {run}: {len(wave) / sr:.1f} s audio, {len(stamps)} "
            f"windows, {len(tokens)} tokens, {steps} S=1 decoder steps in "
            f"{total:.3f} s = {len(wave) / sr / total:.2f}x real time "
            f"(eager, one window at a time); per window "
            + ", ".join(f"{x:.2f}x" for x in per_window))
    log(f"{label} launches: {launches}")
    if len(stamps) != 3:
        raise AssertionError(f"{label}: expected 3 windows, got {len(stamps)}")
    if not tokens:
        raise AssertionError(f"{label}: the transcription returned no tokens")
    return dict(launches=launches, runs=runs, window=bounds[0],
                text=cold_text)


def phase_greedy(params, tr, wave) -> dict:
    from whisper_tpu_torch.pipeline.transcribe import DecodeOptions

    opts = DecodeOptions(strategy="greedy", max_depth=100)
    info = run_slice(tr, wave, opts, "greedy slice")
    for name in ("flash_attention", "encoder_mlp", "decode_attention"):
        if info["launches"][name] == 0:
            raise AssertionError(f"greedy slice never launched {name}")
    # finite encoder output and logits: checked here, outside the timed runs
    start, end = info.pop("window")
    info["paths"] = compare_kernel_and_plain_paths(
        params, tr.cfg, tr.tok, wave[start:end], opts)
    return info


def phase_beam(params, tr, wave) -> dict:
    from whisper_tpu_torch.pipeline.transcribe import DecodeOptions

    opts = DecodeOptions()  # beam search, 5 beams, max_depth 100
    if opts.strategy != "beam" or opts.beam_size != 5:
        raise AssertionError(f"default options are not beam 5: {opts}")
    info = run_slice(tr, wave, opts, "beam slice")
    start, end = info.pop("window")
    info["paths"] = compare_beam_paths(params, tr.cfg, tr.tok,
                                       [wave[start:end]], opts, "beam window")
    return info


def quant_setup(params, tr, wave) -> tuple:
    """The bench's quantized configuration: int8 weight-only
    `quantize_params` of the same bf16 weights, and a Transcriber over
    them."""
    from whisper_tpu_torch.pipeline.transcribe import Transcriber
    from whisper_tpu_torch.quantize import quantize_params

    t0 = time.perf_counter()
    qparams = quantize_params(params, bits=8)
    torch.cuda.synchronize()
    log(f"quantized slices: int8 decoder weights in "
        f"{time.perf_counter() - t0:.1f} s")
    return qparams, Transcriber(qparams, tr.cfg, tr.tok), wave


def phase_quant_greedy(params, tr, wave) -> dict:
    """Greedy over int8 weights, an int8 cross cache and an int8 self
    cache: K1, K2, K3 (cross, integer storage) and K3s (self)."""
    from whisper_tpu_torch.pipeline.transcribe import DecodeOptions

    opts = DecodeOptions(strategy="greedy", max_depth=100, kv_quant=True,
                         self_quant=True)
    info = run_slice(tr, wave, opts, "quantized greedy slice")
    for name in ("flash_attention", "encoder_mlp", "decode_attention",
                 "decode_attention_scaled"):
        if info["launches"][name] == 0:
            raise AssertionError(f"quantized greedy slice never launched "
                                 f"{name}")
    start, end = info.pop("window")
    info["paths"] = compare_kernel_and_plain_paths(
        params, tr.cfg, tr.tok, wave[start:end], opts)
    info["f32_reference"] = compare_quantized_to_f32(
        params, tr.cfg, tr.tok, wave[start:end], opts)
    return info


# The quantized greedy step against the same quantized model (the same
# int8 weights and cache quantization) computed in f32 on the plain path:
# relative L2 of the logits over a prefill and 8 steps, a bound tighter
# than PATH_RTOL. It cannot tell the two dequant products apart (they land
# within 3% of each other), so one matmul is also held at the bit level:
# `_matmul` of a bf16 x with an int8 decoder weight against the product
# in f64 times the scale, cast once to bf16. Kept in f32 until after the
# scale, the product is within one bf16 step of that everywhere and equal
# in more than DEQUANT_EQUAL_SHARE of the elements; rounded to bf16 before
# the scale (the earlier path) it moves many elements by a step.
QUANT_F32_RTOL = 3e-2
DEQUANT_EQUAL_SHARE = 0.98


def dequant_rounding(matmul, x, w) -> tuple:
    """(share of elements equal to the once-rounded f64 product, whether
    every element is within one bf16 step of it, plus the f32 sum's own
    error bound K * 2^-24 * sum |terms| where the terms cancel) of
    `matmul(x, w)` for a 2-D x and QTensor w."""
    from whisper_tpu_torch.quantize import int_values

    q = int_values(w.q).double()
    want = ((x.double() @ q) * w.scale.double()).bfloat16().float()
    f32_sum = (q.shape[0] * 2.0 ** -24
               * (x.double().abs() @ q.abs() * w.scale.double()))
    got = matmul(x, w, "xla").float()
    return (float((got == want).float().mean()),
            bool(((got - want).abs()
                  <= 2 ** -7 * want.abs() + f32_sum).all()))


def compare_quantized_to_f32(params, cfg_k, tok, window, opts) -> dict:
    """One window through the quantized model three ways, all fed the f32
    reference's greedy tokens: the f32 plain path (the reference), the
    kernel path in bf16 (the product kept in f32), and the kernel path
    with the bf16 product (the earlier dequant path: x @ q rounded to
    bf16, then the f32 scale). Relative L2 of the prefill and step logits
    against the reference; the first must be within QUANT_F32_RTOL. Then
    `dequant_rounding` of both products on the first decoder layer's
    mlp1_w (1280 x 5120) at 5 rows: the first must pass."""
    import copy
    import dataclasses

    import whisper_tpu_torch.models.whisper as M
    from whisper_tpu_torch.quantize import QTensor, int_values

    current = M._matmul

    def bf16_product(x, w, int8_impl="xla"):
        if not (isinstance(w, QTensor) and x.dtype == torch.bfloat16
                and int8_impl == "xla"):
            return current(x, w, int8_impl)
        q = int_values(w.q)
        y = torch.matmul(x, q.to(x.dtype).reshape(q.shape[0], -1))
        return (y.reshape(*x.shape[:-1], *q.shape[1:]) * w.scale).to(x.dtype)

    dev = params["encoder"]["conv1_w"].device
    with torch.inference_mode():
        p32 = copy.deepcopy(params).float()
        cfg32 = dataclasses.replace(cfg_k, attention="xla")
        mel = _window_mel([window], cfg_k, opts, dev)
        runs = {"f32": (p32, cfg32, current), "f32_product": (
            params, cfg_k, current), "bf16_product": (
            params, cfg_k, bf16_product)}
        prompt = torch.tensor([tok.prompt_ids("en")], device=dev)
        out, tokens = {}, []
        for name, (pp, cc, mm) in runs.items():
            M._matmul = mm
            try:
                enc = M.encoder_forward(pp, mel, cc)
                cache = M.init_cache(pp, enc, cc, cache_len=128,
                                     kv_quant=opts.kv_quant,
                                     self_quant=opts.self_quant)
                logits, _ = M.decoder_step(pp, prompt, 0, cache, cc)
                out[name] = [logits[:, -1].float()]
                pos = prompt.shape[1]
                for i in range(8):
                    if name == "f32":
                        tokens.append(out[name][-1].argmax(-1)[:, None])
                    logits, _ = M.decoder_step(pp, tokens[i], pos, cache, cc)
                    out[name].append(logits[:, -1].float())
                    pos += 1
            finally:
                M._matmul = current
        del p32
    ref = torch.stack(out["f32"])
    res = {name: rel_err(torch.stack(out[name]), ref)
           for name in ("f32_product", "bf16_product")}
    log(f"quantized greedy window vs its f32 reference (relative L2 of the "
        f"prefill + 8 step logits): f32 product {res['f32_product']:.4g} "
        f"(limit {QUANT_F32_RTOL}), bf16 product (before) "
        f"{res['bf16_product']:.4g}")
    if not bool(torch.isfinite(torch.stack(out["f32_product"])).all()):
        raise AssertionError("quantized logits are not finite")
    if not res["f32_product"] <= QUANT_F32_RTOL:
        raise AssertionError(f"quantized step vs f32 reference: {res}")
    blk = params["decoder"]["blocks"]["mlp1_w"]
    w = QTensor(blk.q[0], blk.scale[0])
    x = _randn((5, w.q.shape[0]),
               torch.Generator(device=dev).manual_seed(SEED))
    for name, mm in (("f32_product", current), ("bf16_product", bf16_product)):
        res[f"{name}_equal_share"], res[f"{name}_one_step"] = \
            dequant_rounding(mm, x, w)
    log(f"dequant matmul 5 x 1280 x 5120 vs the f64 product cast once: "
        f"f32 product {res['f32_product_equal_share']:.4f} equal (limit > "
        f"{DEQUANT_EQUAL_SHARE}), within one bf16 step "
        f"{res['f32_product_one_step']}; bf16 product (before) "
        f"{res['bf16_product_equal_share']:.4f} equal, within one step "
        f"{res['bf16_product_one_step']}")
    if not (res["f32_product_one_step"]
            and res["f32_product_equal_share"] > DEQUANT_EQUAL_SHARE):
        raise AssertionError(f"dequant product rounds more than once: {res}")
    return res


def phase_quant_beam(params, tr, wave) -> dict:
    """The bench's default configuration: beam 5 over int8 weights, an int4
    cross cache and an int8 self cache: K1, K2, K3g (int4 storage) and K5
    (the fused copy-on-write reshuffle), no K4."""
    from whisper_tpu_torch.pipeline.transcribe import DecodeOptions

    opts = DecodeOptions(kv_quant="int4", self_quant=True)
    info = run_slice(tr, wave, opts, "quantized beam slice")
    for name in ("flash_attention", "encoder_mlp", "decode_attention_group",
                 "permute_attention"):
        if info["launches"][name] == 0:
            raise AssertionError(f"quantized beam slice never launched {name}")
    start, end = info.pop("window")
    info["paths"] = compare_beam_paths(params, tr.cfg, tr.tok,
                                       [wave[start:end]], opts,
                                       "quantized beam window")
    return info


def run_many_slice(bt, waves, opts, label: str) -> dict:
    """Cold and warm `BatchTranscriber.transcribe_many` runs over the
    streams; the launch counts are set to 0 just before the cold run and
    read just after it. The warm texts must equal the cold ones."""
    sr = 16000
    audio_s = sum(len(w) for w in waves) / sr
    n_layer = bt.cfg.text_decoder_config.n_text_layer
    runs = []
    for run in ("cold", "warm"):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = bt.transcribe_many(waves, sr, opts)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = launch_counts()
        texts = [r[0] for r in results]
        if run == "cold":
            launches, cold_texts = counts, texts
        elif texts != cold_texts:
            raise AssertionError(f"{label}: the warm run's texts differ")
        steps = sum(counts[n] for n in (
            "decode_attention", "decode_attention_group",
            "decode_attention_scaled", "permute_attention",
            "decode_attention_scaled_int4",
            "permute_attention_int4")) // (2 * n_layer)
        runs.append(dict(run=run, seconds=total, xrt=audio_s / total,
                         decoder_steps=steps,
                         n_tokens=[len(r[1]) for r in results],
                         text_chars=[len(t) for t in texts]))
        log(f"{label} {run}: {len(waves)} streams, {audio_s:.1f} s audio, "
            f"{runs[-1]['n_tokens']} tokens, {steps} S=1 decoder steps in "
            f"{total:.3f} s = {audio_s / total:.2f}x real time (batch "
            f"{bt.batch_size})")
        if not all(r[1] for r in results):
            raise AssertionError(f"{label}: a stream returned no tokens")
    log(f"{label} launches: {launches}")
    return dict(launches=launches, runs=runs, texts=cold_texts)


def _full_windows(waves, cfg, opts) -> list:
    """The full-length windows of the streams, in the pipeline's order."""
    from whisper_tpu_torch.ops import audio
    from whisper_tpu_torch.pipeline.transcribe import window_waveform

    n = audio.max_waveform_samples(cfg.encoder_ctx_size - opts.padding)
    return [w[a:b] for w in waves for a, b in window_waveform(
        w, 16000, n, int(16000 * opts.chunk_overlap_seconds)) if b - a == n]


def phase_batched_greedy(tr, waves, greedy_text) -> dict:
    """bf16 greedy over the two streams, their 4 full windows as one
    batch (K1, K2 at 4 x 750 rows, K3 at B = 4), the 2 tails one at a
    time. Whether each stream's text equals `Transcriber.transcribe`'s is
    reported, not asserted (the CPU tests assert it)."""
    from whisper_tpu_torch.pipeline.batch import BatchTranscriber
    from whisper_tpu_torch.pipeline.transcribe import DecodeOptions

    opts = DecodeOptions(strategy="greedy", max_depth=100)
    bt = BatchTranscriber(tr.params, tr.cfg, tr.tok, batch_size=4)
    info = run_many_slice(bt, waves, opts, "batched greedy slice")
    for name in ("flash_attention", "encoder_mlp", "decode_attention"):
        if info["launches"][name] == 0:
            raise AssertionError(f"batched greedy slice never launched {name}")
    single = [greedy_text, tr.transcribe(waves[1], 16000, opts,
                                         on_chunk=lambda i, t: None)[0]]
    info["same_text_as_transcribe"] = [
        a == b for a, b in zip(info.pop("texts"), single)]
    log(f"batched greedy texts == transcribe texts: "
        f"{info['same_text_as_transcribe']}")
    return info


def w8a8_setup(params, tr) -> tuple:
    """W8A8: int8 `quantize_params` of the bf16 weights, the encoder's
    too, with `int8_impl="pallas"`, and a BatchTranscriber of 4 windows."""
    import dataclasses

    from whisper_tpu_torch.config import KernelKnobs
    from whisper_tpu_torch.pipeline.batch import BatchTranscriber
    from whisper_tpu_torch.quantize import quantize_params

    t0 = time.perf_counter()
    qparams = quantize_params(params, quantize_encoder=True, bits=8)
    torch.cuda.synchronize()
    log(f"w8a8 slice: int8 encoder and decoder weights in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg = dataclasses.replace(tr.cfg, knobs=KernelKnobs(int8_impl="pallas"))
    return qparams, BatchTranscriber(qparams, cfg, tr.tok, batch_size=4)


def phase_w8a8_batched_beam(qparams, bt, waves) -> dict:
    """Beam 5 over W8A8 weights, an int4 cross cache and an int8 self
    cache: the 4 full windows as one batch (encoder 3000 rows: K7; 20
    lanes: K6, K3g, K5), the 2 tails one at a time (encoder 750 rows: K6).
    Then the kernel path against the plain path on the 4 windows, and the
    relative L2 between the W8A8 and the dequant ("xla") encoder outputs
    (printed, not held to a limit)."""
    import dataclasses

    import whisper_tpu_torch.models.whisper as M
    from whisper_tpu_torch.config import KernelKnobs
    from whisper_tpu_torch.pipeline.transcribe import DecodeOptions

    opts = DecodeOptions(kv_quant="int4", self_quant=True)
    info = run_many_slice(bt, waves, opts, "w8a8 batched beam slice")
    info.pop("texts")
    for name in ("flash_attention", "decode_attention_group",
                 "permute_attention", "quantized_matmul",
                 "quantized_matmul_big"):
        if info["launches"][name] == 0:
            raise AssertionError(f"w8a8 batched beam slice never launched "
                                 f"{name}")
    windows = _full_windows(waves, bt.cfg, opts)
    if len(windows) != 4:
        raise AssertionError(f"expected 4 full windows, got {len(windows)}")
    info["paths"] = compare_beam_paths(qparams, bt.cfg, bt.tok, windows, opts,
                                       "w8a8 batched beam (4 windows)")
    with torch.inference_mode():
        mel = _window_mel(windows, bt.cfg, opts)
        deq = dataclasses.replace(bt.cfg, knobs=KernelKnobs())
        info["w8a8_vs_dequant_encoder"] = rel_err(
            M.encoder_forward(qparams, mel, bt.cfg),
            M.encoder_forward(qparams, mel, deq))
    log(f"w8a8 vs dequant encoder output (relative L2, no limit): "
        f"{info['w8a8_vs_dequant_encoder']:.4g}")
    return info


def phase_int4_agreement(params, tr, wave) -> dict:
    """The quantization agreement gate over the int4 configuration, at
    large-v2's full width and depth: `decode_agreement` of the bf16
    weights against `quantize_params(bits=4, quantize_encoder=True)` under
    int8_impl="pallas" with an int4 cross and an int4 self cache, greedy
    and beam 5 over 2 seeded windows of 32 steps. The test decodes run K7
    over packed int4 in the batched encoder (2 x 750 = 1500 rows), K6 in
    the decoder, K3 / K3g over the int4 cross cache, K3s over the int4 self
    cache (greedy) and K5 over it (beam). The report is printed, not
    gated: random weights make bf16 and int4 tokens diverge by
    construction. Held: each int4 variant launched, a finite logit delta,
    and on one window of the same configuration the kernel path against
    the plain path, greedy and beam (prefill + 8 steps each, PATH_RTOL),
    with K5's reshuffled int4 rows equal to the rows they were copied
    from. There both decoders read the kernel path's encoder output
    (`shared_encoder`; the encoders are compared apart): the int4 self
    cache turns the encoders' bf16-level difference into whole-step flips
    of its values (`tools/int4_path_gap.py` finds which storage does). The
    unshared greedy comparison that every other slice passes is printed
    once beside it, not held to a limit."""
    import dataclasses
    import math

    from whisper_tpu_torch.config import KernelKnobs
    from whisper_tpu_torch.eval.agreement import decode_agreement
    from whisper_tpu_torch.ops import audio
    from whisper_tpu_torch.pipeline.transcribe import DecodeOptions
    from whisper_tpu_torch.quantize import quantize_params

    cfg = dataclasses.replace(tr.cfg, knobs=KernelKnobs(int8_impl="pallas"))
    t0 = time.perf_counter()
    qparams = quantize_params(params, quantize_encoder=True, bits=4)
    torch.cuda.synchronize()
    log(f"int4 agreement: int4 encoder and decoder weights in "
        f"{time.perf_counter() - t0:.1f} s")
    tok = tr.tok
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = decode_agreement(
        params, qparams, cfg, eot_id=tok.eot, prompt=tok.prompt_ids("en"),
        suppress_mask=tok.suppress_mask(), n_windows=2, max_depth=32,
        beam_size=5, kv_quant_test="int4", self_quant_test="int4")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    log(f"int4 agreement: decode_agreement in {seconds:.1f} s (2 windows, "
        f"greedy and beam 5, 32 steps; reference and test): "
        + json.dumps(report))
    log(f"int4 agreement launches: {launches}")
    never = [n for n in ("decode_attention_scaled_int4",
                         "permute_attention_int4", "quantized_matmul_int4",
                         "quantized_matmul_big_int4", "decode_attention",
                         "decode_attention_group") if launches[n] == 0]
    if never:
        raise AssertionError(f"int4 agreement never launched {never}")
    if not math.isfinite(report["max_logit_delta_rel"]):
        raise AssertionError(f"int4 agreement: logit delta "
                             f"{report['max_logit_delta_rel']}")
    opts = DecodeOptions(kv_quant="int4", self_quant="int4")
    n_window = audio.max_waveform_samples(cfg.encoder_ctx_size - opts.padding)
    window = wave[:n_window]
    paths = compare_kernel_and_plain_paths(
        qparams, cfg, tok, window, opts, shared_encoder=True,
        label="int4 greedy window (shared encoder output)")
    beam_paths = compare_beam_paths(
        qparams, cfg, tok, [window], opts,
        "int4 beam window (shared encoder output)", shared_encoder=True)
    unshared = compare_kernel_and_plain_paths(
        qparams, cfg, tok, window, opts, limit=None,
        label="int4 greedy window (each path's own encoder output)")
    del qparams
    return dict(launches=launches, seconds=seconds, report=report,
                paths=paths, beam_paths=beam_paths, unshared_paths=unshared)


def _window_mel(windows, cfg, opts, device="cuda"):
    """The windows' log-mel, clipped and padded as the pipeline does (the
    batch pipeline's per-sample clamp; one window's is the same)."""
    from whisper_tpu_torch.ops import audio

    x = torch.from_numpy(np.stack(windows)).to(device)
    mel = audio.prep_audio(x, per_sample_max=True)
    keep = min(mel.shape[2], cfg.encoder_ctx_size - opts.padding)
    return torch.nn.functional.pad(mel[:, :, :keep], (0, opts.padding))


def _window_encodings(params, cfg_k, windows, opts):
    """The windows' log-mel through both encoders: {attention: enc}."""
    import dataclasses

    import whisper_tpu_torch.models.whisper as M

    cfg_p = dataclasses.replace(cfg_k, attention="xla")
    mel = _window_mel(windows, cfg_k, opts)
    return cfg_p, {c.attention: M.encoder_forward(params, mel, c)
                   for c in (cfg_k, cfg_p)}


def _check_paths(label: str, res: dict, finite: dict,
                 limit=PATH_RTOL) -> dict:
    """Finite kernel-path outputs, and each relative L2 within `limit`
    (None: printed only)."""
    for name, t in finite.items():
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{label}: kernel path {name} is not finite")
    log(f"{label}: kernel path vs plain path (relative L2, "
        + ("no limit" if limit is None else f"limit {limit}") + "): "
        + ", ".join(f"{k} {v:.3g}" for k, v in res.items()))
    bad = {k: v for k, v in res.items()
           if limit is not None and not v <= limit}
    if bad:
        raise AssertionError(f"{label}: kernel and plain paths disagree: {bad}")
    return res


def compare_kernel_and_plain_paths(params, cfg_k, tok, window, opts,
                                   shared_encoder: bool = False,
                                   limit=PATH_RTOL, label=None):
    """One window through the kernel path and the plain path: encoder
    output, prefill logits and 8 greedy steps (the same tokens fed to both,
    so near-ties of random weights cannot split them). With
    `shared_encoder` both decoders read the kernel path's encoder output
    (the encoders are still compared)."""
    import whisper_tpu_torch.models.whisper as M

    with torch.inference_mode():
        cfg_p, enc = _window_encodings(params, cfg_k, [window], opts)
        prompt = torch.tensor([tok.prompt_ids("en")], device="cuda")
        out, caches = {}, {}
        for c in (cfg_k, cfg_p):
            xa = enc["flash" if shared_encoder else c.attention]
            cache = M.init_cache(params, xa, c, cache_len=128,
                                 kv_quant=opts.kv_quant,
                                 self_quant=opts.self_quant)
            logits, _ = M.decoder_step(params, prompt, 0, cache, c)
            out[c.attention], caches[c.attention] = [logits[:, -1]], cache
        # feed the kernel path's greedy tokens to both paths
        pos = prompt.shape[1]
        for _ in range(8):
            nxt = out["flash"][-1].argmax(-1)[:, None]
            for c in (cfg_k, cfg_p):
                logits, _ = M.decoder_step(params, nxt, pos,
                                           caches[c.attention], c)
                out[c.attention].append(logits[:, -1])
            pos += 1
    res = {"encoder": rel_err(enc["flash"], enc["xla"]),
           "prefill_logits": rel_err(out["flash"][0], out["xla"][0]),
           "step_logits": max(rel_err(a, b) for a, b in
                              zip(out["flash"][1:], out["xla"][1:]))}
    if label is None:
        label = "quantized greedy window" if opts.self_quant else "greedy window"
    return _check_paths(label, res, {
        "encoder": enc["flash"], "logits": torch.stack(out["flash"])}, limit)


def compare_beam_paths(params, cfg_k, tok, windows, opts, label: str,
                       steps: int = 8, shared_encoder: bool = False,
                       limit=PATH_RTOL):
    """Prefill + `steps` beam steps (K lanes per window, one cross cache a
    window) over the windows through the kernel path and the plain path,
    both fed the kernel path's tokens and window-local parents: each
    step's logits within PATH_RTOL. bf16 caches
    reshuffle through K4 (its plain version on the plain path) into spare
    buffers, and the kernel path's permuted caches must equal, bit for bit,
    `torch.index_select` of the buffers they were permuted from. A
    quantized (int8 or int4) self cache (`opts.self_quant`) reshuffles as
    `beam_search` does: inside K5 with copy-on-write slots on the kernel
    path, through K4's plain prefix copy on the plain path; there the rows
    [0, pos) that K5 leaves in each lane's slot, and their scales, must
    equal, bit for bit, those of the slot it read (what K5's plain
    version copies). `shared_encoder` as in
    `compare_kernel_and_plain_paths`."""
    import whisper_tpu_torch.models.whisper as M
    from whisper_tpu_torch.decode.beam import _cow_assign, _spare, top_k_stable
    from whisper_tpu_torch.ops.kernels.permute import (
        permute_lanes_arrays, permute_lanes_arrays_plain)
    from whisper_tpu_torch.quantize import QTensor

    def flat(kv):
        return [a for t in kv for a in (t if isinstance(t, QTensor) else (t,))]

    k = opts.beam_size
    w = len(windows)
    v = cfg_k.text_decoder_config.n_vocab
    fused = bool(opts.self_quant)
    with torch.inference_mode():
        cfg_p, enc = _window_encodings(params, cfg_k, windows, opts)
        prompt = torch.tensor(tok.prompt_ids("en"), device="cuda")
        tokens = prompt[None].expand(w * k, -1).contiguous()
        out, caches, spares = {}, {}, {}
        for c in (cfg_k, cfg_p):
            xa = enc["flash" if shared_encoder else c.attention]
            cache = M.init_cache(params, xa, c, batch=w * k,
                                 cache_len=128, kv_quant=opts.kv_quant,
                                 self_quant=opts.self_quant)
            logits, cache = M.decoder_step(params, tokens, 0, cache, c)
            out[c.attention], caches[c.attention] = [logits[:, -1]], cache
            spares[c.attention] = (_spare(cache.self_k), _spare(cache.self_v))
        lane = torch.arange(k, device="cuda")
        offs = (torch.arange(w, device="cuda") * k)[:, None]
        phys = lane.repeat(w, 1)
        cur_logp = torch.where(lane == 0, 0.0, float("-inf")).repeat(w, 1)
        pos, exact = prompt.shape[0], True
        for _ in range(steps):
            logp = torch.log_softmax(out["flash"][-1].float(), -1)
            cur_logp, flat_idx = top_k_stable(
                (cur_logp[:, :, None] + logp.view(w, k, v)).reshape(w, -1), k)
            parent = flat_idx // v  # (W, K), window-local
            tok_ids = (flat_idx % v).reshape(-1)
            gparent = (parent + offs).reshape(-1).to(torch.int32)
            for c, permute in ((cfg_k, permute_lanes_arrays),
                               (cfg_p, permute_lanes_arrays_plain)):
                a = c.attention
                cache = caches[a]
                if fused and a == "flash":
                    src, dest = _cow_assign(parent, phys)
                    gsrc = (src + offs).reshape(-1)
                    gdest = (dest + offs).reshape(-1)
                    before = [t.clone() for t in flat((cache.self_k,
                                                       cache.self_v))]
                    logits, caches[a] = M.decoder_step(
                        params, tok_ids[:, None], pos, cache, c,
                        parents=gsrc, dests=gdest)
                    after = flat((caches[a].self_k, caches[a].self_v))
                    exact &= all(bool(torch.equal(
                        n.index_select(0, gdest)[:, :, :pos],
                        b.index_select(0, gsrc)[:, :, :pos]))
                        for n, b in zip(after, before))
                    phys = dest
                    out[a].append(logits[:, -1])
                    continue
                sources = flat((cache.self_k, cache.self_v))
                new = permute(sources, gparent, flat(spares[a]),
                              valid_len=pos if fused else None)
                if a == "flash":
                    idx = gparent.long()
                    exact &= all(bool(torch.equal(n, torch.index_select(
                        src_arr, 0, idx))) for n, src_arr in zip(new, sources))
                spares[a] = (cache.self_k, cache.self_v)
                if fused:
                    new = (QTensor(new[0], new[1]), QTensor(new[2], new[3]))
                cache = M.DecoderCache(*new, cache.cross_k, cache.cross_v)
                logits, caches[a] = M.decoder_step(params, tok_ids[:, None],
                                                   pos, cache, c)
                out[a].append(logits[:, -1])
            pos += 1
    if not exact:
        raise AssertionError(("K5's reshuffled" if fused else "K4's permuted")
                             + " self caches differ from the rows they were "
                             "copied from")
    res = {"encoder": rel_err(enc["flash"], enc["xla"]),
           "prefill_logits": rel_err(out["flash"][0], out["xla"][0]),
           "step_logits": max(rel_err(a, b) for a, b in
                              zip(out["flash"][1:], out["xla"][1:]))}
    res = _check_paths(label, res, {
        "encoder": enc["flash"], "logits": torch.stack(out["flash"])}, limit)
    return dict(res, permuted_caches_equal=exact)


if __name__ == "__main__":
    sys.exit(main())
