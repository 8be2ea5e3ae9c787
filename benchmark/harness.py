"""One run of one cell: set the program up, warm up, measure whole
rotations of the traffic, optionally profile one call, free the program,
judge its answers, and build the result line.

A cell (`<config>.<traffic>` in BENCHMARK.json) is found by name: its
configuration in `configs/<config>.json`, its traffic in
`traffic/<traffic>.json`, the limits of its correctness check in
`limits/<cell>.json`, and each per-layer metric's reader in
`metrics/<metric>.py`. Adding a cell, a mix or a metric adds files and
entries; nothing here names one.

A configuration states how the program is built: its sizes, and
optionally `quantize` ({"bits": 8 or 4, "encoder": bool}, the program's
`quantize_params`), `knobs` (the program's `KernelKnobs`) and `options`
(decode options of the deployment, such as its cache quantization, laid
over the traffic's). The traffic's `entry` names the program's entry
point: `BatchTranscriber.transcribe_many` is built in (`Program`); a mix
that drives another entry brings `traffic/<traffic>.py` beside its data,
which defines `Program` (the interface of the class below) and may define
`judge` (that of `check.judge`) where its answers are judged otherwise.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from . import check, counts
from . import traffic as tr
from .trace import Trace, events_from_profiler
from .weights import make_weights

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / "build" / "benchmark"  # the tokenizer files, made once


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    traffic_name: str = ""


def _read(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = _read(bench_path)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {bench_path.name}")
    return make_cell(entry["config"], entry["traffic"], int(entry["chips"]),
                     [m for m in bench["end_to_end"] if _reports(m, name)],
                     [m for m in bench["per_layer"] if _reports(m, name)])


def make_cell(config: str, traffic: str, chips: int = 1,
              end_to_end: Optional[List[Dict]] = None,
              per_layer: Optional[List[Dict]] = None) -> Cell:
    """The cell `<config>.<traffic>` from its files, whether or not
    BENCHMARK.json lists it (no limits file: no number is held)."""
    name = f"{config}.{traffic}"
    limits = HERE / "limits" / f"{name}.json"
    return Cell(name, chips, _read(HERE / "configs" / f"{config}.json"),
                _read(HERE / "traffic" / f"{traffic}.json"),
                _read(limits) if limits.exists() else {"numbers": {}},
                end_to_end or [], per_layer or [], traffic)


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str):
    """The `read(trace, ctx)` of metrics/<metric>.py."""
    return _module(HERE / "metrics" / f"{metric}.py",
                   "benchmark_metric_" + metric.replace(".", "_")).read


def entry(cell: Cell):
    """(the Program class, the judge) of the cell's traffic: those of
    `traffic/<traffic>.py` where it exists, else the built-in entry."""
    path = HERE / "traffic" / f"{cell.traffic_name}.py"
    if cell.traffic_name and path.exists():
        module = _module(path, "benchmark_traffic_"
                         + cell.traffic_name.replace("-", "_"))
        return module.Program, getattr(module, "judge", check.judge)
    if cell.traffic["entry"] != "BatchTranscriber.transcribe_many":
        raise ValueError(f"unknown entry {cell.traffic['entry']!r} and no "
                         f"traffic/{cell.traffic_name}.py")
    return Program, check.judge


def program_config(cfg: Dict):
    """The program's WhisperConfig for a configuration file's sizes."""
    from whisper_tpu_torch.config import (AudioEncoderConfig, KernelKnobs,
                                          TextDecoderConfig, WhisperConfig)

    d = cfg["d_model"]
    if cfg["encoder_ffn_dim"] != 4 * d or cfg["decoder_ffn_dim"] != 4 * d:
        raise ValueError("the program's MLP width is 4 * d_model")
    return WhisperConfig(
        audio_encoder_config=AudioEncoderConfig(
            n_mels=cfg["num_mel_bins"], n_audio_ctx=cfg["max_source_positions"],
            n_audio_state=d, n_audio_head=cfg["encoder_attention_heads"],
            n_audio_layer=cfg["encoder_layers"]),
        text_decoder_config=TextDecoderConfig(
            n_vocab=cfg["vocab_size"], n_text_ctx=cfg["max_target_positions"],
            n_text_state=d, n_text_head=cfg["decoder_attention_heads"],
            n_text_layer=cfg["decoder_layers"]),
        knobs=KernelKnobs(**cfg.get("knobs", {})))


def tokenizer(cfg: Dict, cache: Path):
    """The program's tokenizer for the configuration, written once into
    `cache` (a fixed path) and loaded from there."""
    from whisper_tpu_torch.text.tokenizer import (
        WhisperTokenizer, build_full_scale_tokenizer_json)

    v3 = bool(cfg["tokens"]["v3_layout"])
    path = cache / f"tokenizer_{'v3' if v3 else 'v2'}.json"
    if not path.exists():
        cache.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        build_full_scale_tokenizer_json(str(tmp), v3=v3)
        tmp.replace(path)
    return WhisperTokenizer(str(path))


def warmup_lengths(traffic: Dict, geo: tr.Geometry) -> List[int]:
    """Recordings that give the shapes a run uses and no others: one full
    batch of windows (and a tail), then recordings of each rotation
    recording's partial windows (its tails, at their lengths)."""
    out = [(traffic["batch_size"] - 1) * geo.shift + geo.window]
    seen = set()
    for lengths in tr.rotation(traffic):
        for n in lengths:
            parts = [(s, e) for s, e in tr.windows(n, geo)
                     if e - s < geo.window]
            if parts and tuple(e - s for s, e in parts) not in seen:
                seen.add(tuple(e - s for s, e in parts))
                out.append(n - parts[0][0])
    return out


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Program:
    """The system under test: a BatchTranscriber over the benchmark's
    weights (quantized as the configuration says), and the decode options
    of the traffic with the configuration's laid over them. Each call
    keeps the windows' tokens that `transcribe_many` spliced, read from
    the pipeline's own `_decode_windows` as it returns them."""

    def __init__(self, cell: Cell, seed: int, device,
                 cache: Optional[Path] = None):
        from whisper_tpu_torch.params import ParamTree
        from whisper_tpu_torch.pipeline.batch import BatchTranscriber
        from whisper_tpu_torch.pipeline.transcribe import DecodeOptions
        from whisper_tpu_torch.quantize import quantize_params

        self.device = device
        t0 = time.perf_counter()
        tok = tokenizer(cell.config, cache or CACHE)
        t1 = time.perf_counter()
        params = ParamTree(make_weights(cell.config, seed, device))
        quant = cell.config.get("quantize")
        if quant:
            params = quantize_params(params, quant.get("encoder", False),
                                     bits=quant["bits"])
        _sync(device)
        t2 = time.perf_counter()
        self.transcriber = BatchTranscriber(
            params, program_config(cell.config), tok,
            batch_size=cell.traffic["batch_size"], device=device)
        self.options = DecodeOptions(**{**cell.traffic["options"],
                                        **cell.config.get("options", {})})
        self.setup = {"tokenizer_s": t1 - t0, "weights_s": t2 - t1}
        self._windows = None
        decode = self.transcriber._decode_windows

        def keep(*args, **kwargs):
            out = decode(*args, **kwargs)
            self._windows = out
            return out

        self.transcriber._decode_windows = keep

    def call(self, waves, options=None):
        """One call (the traffic's options by default) -> (each
        recording's tokens, each recording's windows' tokens)."""
        self._windows = None
        out = self.transcriber.transcribe_many(waves,
                                               options=options or self.options)
        results, _, _, n_windows = self._windows
        windows = [[results.get((s, w)) for w in range(n_windows[s])]
                   for s in range(len(waves))]
        return [list(tokens) for _, tokens in out], windows


def timed_call(program: Program, call: tr.Call, seed: int,
               device) -> check.CallRecord:
    waves = [tr.host_audio(n, seed, call.index, r, device)
             for r, n in enumerate(call.lengths)]
    _sync(device)
    t0 = time.perf_counter()
    try:
        (tokens, windows), error = program.call(waves), None
    except Exception as e:  # a call that raises is a failed request
        tokens = windows = None
        error = f"{type(e).__name__}: {e}"
    _sync(device)
    return check.CallRecord(call, time.perf_counter() - t0, tokens, windows,
                            error)


def measure(program: Program, traffic: Dict, seed: int, seconds: float,
            device) -> List[check.CallRecord]:
    """Whole rotations of the traffic's calls: another rotation starts only
    while the window, with one more rotation as long as the last, stays
    within `seconds`; the first always runs."""
    rot = tr.rotation(traffic)
    records: List[check.CallRecord] = []
    t0 = time.perf_counter()
    r = 0
    while True:
        t_rot = time.perf_counter()
        for i, lengths in enumerate(rot):
            call = tr.Call(r * len(rot) + i, lengths)
            records.append(timed_call(program, call, seed, device))
        r += 1
        now = time.perf_counter()
        if now - t0 + (now - t_rot) > seconds:
            return records


def profile_call(program: Program, call: tr.Call, seed: int, device):
    """(events, wall seconds) of one call under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    waves = [tr.host_audio(n, seed, call.index, r, device)
             for r, n in enumerate(call.lengths)]
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        program.call(waves)
        _sync(device)
        wall = time.perf_counter() - t0
    return events_from_profiler(prof), wall


def window_work(records, cfg: Dict, traffic: Dict) -> Tuple[float, float]:
    """(audio seconds, useful operations) of the windows decoded by the
    completed calls."""
    geo = tr.geometry(cfg, traffic)
    opt = traffic["options"]
    lanes = opt["beam_size"] if opt["strategy"] == "beam" else 1
    prompt = len(cfg["tokens"]["prompt_en_transcribe_notimestamps"])
    audio_s = flops = 0.0
    for rec in records:
        if rec.tokens is None:
            continue
        for n in rec.call.lengths:
            audio_s += n / tr.SAMPLE_RATE
            for s, e in tr.windows(n, geo):
                frames = counts.window_frames(e - s, cfg["max_source_positions"],
                                              geo.padding)
                flops += counts.window_flops(frames, prompt, opt["max_depth"],
                                             lanes, cfg)
    return audio_s, flops


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, cache: Optional[Path] = None
             ) -> Tuple[Dict, List[str]]:
    """One run; returns (the result line's object, the check lines)."""
    cfg, traffic = cell.config, cell.traffic
    geo = tr.geometry(cfg, traffic)
    program_cls, judge = entry(cell)
    t_program = time.perf_counter()
    program = program_cls(cell, seed, device, cache)
    t_warm = time.perf_counter()
    # a full batch at the traffic's depth (the allocator reaches its
    # steady size), then each tail shape through a few steps
    warm = [tr.host_audio(n, seed, 10 ** 6, i, device)
            for i, n in enumerate(warmup_lengths(traffic, geo))]
    program.call(warm[:1])
    program.call(warm[1:], dataclasses.replace(program.options, max_depth=3))
    del warm
    _sync(device)
    setup_s = time.perf_counter() - t_start
    setup = {"imports_s": t_program - t_start, **program.setup,
             "warmup_s": time.perf_counter() - t_warm}

    is_cuda = torch.device(device).type == "cuda"
    if is_cuda:
        torch.cuda.reset_peak_memory_stats()
    records = measure(program, traffic, seed, seconds, device)
    wall = sum(r.wall_s for r in records)
    audio_s, flops = window_work(records, cfg, traffic)

    trace_obj: Optional[Trace] = None
    if trace:
        first = records[0]
        events, p_wall = profile_call(program, first.call, seed, device)
        counts_ = tr.window_counts(first.call.lengths, geo,
                                   traffic["batch_size"])
        trace_obj = Trace.from_events(events, p_wall, {
            "windows": counts_["full"] + counts_["tails"], **counts_,
            "unprofiled_wall_s": first.wall_s,
            "window_flops": flops, "window_wall_s": wall})
        del events
    device_info = {"platform": "gpu" if is_cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if is_cuda
                            else "cpu"),
                   "count": cell.chips,
                   "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                         if is_cuda else 0)}
    del program
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()

    verdict = judge(records, cfg, traffic, cell.limits, seed, device)
    metrics: Dict[str, Dict] = {}
    if trace_obj is None:
        values = {"xrt": audio_s / wall if wall else None, "setup_s": setup_s}
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        ctx = {"config": cfg, "traffic": traffic,
               "prompt_len": len(cfg["tokens"]["prompt_en_transcribe_notimestamps"])}
        for m in cell.per_layer:
            value = reader(m["name"])(trace_obj, ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = trace_obj.busy_ns() / 1e9
        device_info["window_s"] = trace_obj.wall_s
    result = {"correct": verdict.correct, "attempted": len(records),
              "failed": verdict.failed, "metrics": metrics,
              "device": device_info}
    if trace_obj is not None:
        result["breakdown"] = {"device_ops": trace_obj.top_device_ops(),
                               "idle_gaps": trace_obj.idle_gaps()}
    result["checks"] = verdict.checks
    lines = ["setup: " + ", ".join(f"{k} {v:.3f}" for k, v in setup.items())]
    for r in records:
        c = tr.window_counts(r.call.lengths, geo, traffic["batch_size"])
        audio = sum(r.call.lengths) / tr.SAMPLE_RATE
        lines.append(f"call {r.call.index}: {audio / 60:.1f} min, {c['full']} "
                     f"full windows + {c['tails']} tails + {c['padding']} "
                     f"padding rows, {r.wall_s:.3f} s, xrt {audio / r.wall_s:.1f}"
                     + (f", raised {r.error}" if r.error else ""))
    if trace_obj is not None:
        lines.append(f"profiled call: {trace_obj.wall_s:.3f} s, "
                     f"{trace_obj.launches()} launches, {trace_obj.syncs} syncs")
    lines += [f"reading {name}: {v!r} (not compared)"
              for name, v in getattr(verdict, "readings", {}).items()]
    lines += [f"check {name}: {c['value']!r} (limit {c['limit']!r})"
              for name, c in verdict.checks.items()]
    return result, lines
