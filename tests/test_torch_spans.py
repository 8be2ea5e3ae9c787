"""The phase spans of the port's bulk path (`utils/profiling.scope`) on the
CPU: free without a profiler, the span tree of
`BatchTranscriber.transcribe_many` under `torch.profiler`, and the same
tokens with the profiler on and off.

Setup: the synthetic tokenizer and a 2-layer n_state-32 model made by the
port's `init_params` (ENC_CTX 96: ~0.86 s windows, no overlap), batch 2,
two streams of 2.6 and 1.3 windows (3 full windows and 2 tails), greedy
and beam search at MAX_DEPTH 6.
"""

import math

import numpy as np
import pytest
import torch

from whisper_tpu_torch.config import tiny_test_config
from whisper_tpu_torch.ops.audio import max_waveform_samples
from whisper_tpu_torch.params import init_params
from whisper_tpu_torch.pipeline import batch as TB
from whisper_tpu_torch.pipeline.transcribe import (DecodeOptions,
                                                   plan_windows)
from whisper_tpu_torch.text.tokenizer import (WhisperTokenizer,
                                              build_test_tokenizer_json)
from whisper_tpu_torch.utils import profiling

from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

ENC_CTX = 96
MAX_DEPTH = 6
BATCH = 2

# span -> the spans it may sit directly inside
PARENTS = {
    "whisper.transcribe_many": {None},
    "whisper.window": {"whisper.transcribe_many"},
    "whisper.batch": {"whisper.transcribe_many"},
    "whisper.batch.stack": {"whisper.batch"},
    "whisper.encode": {"whisper.batch", "whisper.tail"},
    "whisper.decode": {"whisper.batch", "whisper.tail"},
    "whisper.decode.prefill": {"whisper.decode"},
    "whisper.decode.step": {"whisper.decode"},
    "whisper.decode.sync": {"whisper.decode.step"},
    "whisper.readback": {"whisper.batch"},
    "whisper.tail": {"whisper.transcribe_many"},
    "whisper.stitch": {"whisper.transcribe_many"},
}


@pytest.fixture(scope="module")
def transcriber(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_spans") / "tokenizer.json")
    build_test_tokenizer_json(path)
    tok = WhisperTokenizer(path)
    cfg = tiny_test_config(n_state=32, n_head=2, n_layer=2,
                           n_vocab=tok.vocab_size, n_audio_ctx=ENC_CTX,
                           n_text_ctx=48)
    params = init_params(cfg, torch.Generator().manual_seed(7))
    return TB.BatchTranscriber(params, cfg, tok, batch_size=BATCH,
                               device="cpu")


def _streams():
    n = max_waveform_samples(ENC_CTX - 10)
    rng = np.random.default_rng(3)
    return [(0.3 * rng.standard_normal(int(f * n))).astype(np.float32)
            for f in (2.6, 1.3)]


def _options(strategy):
    return DecodeOptions(strategy=strategy, max_depth=MAX_DEPTH,
                         chunk_overlap_seconds=0.0)


def _windows(cfg, waves):
    """(full windows, tails) as `_decode_windows` splits the streams."""
    kinds = [w.kind for wave in waves
             for w in plan_windows(wave, 16000, cfg, _options("greedy"))]
    return kinds.count("full"), kinds.count("tail")


def _spans(prof):
    """[(start_ns, end_ns, name, parent name)] of the whisper.* spans, the
    parent being the innermost span around each (one thread: by time)."""
    spans = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("whisper.")),
                   key=lambda s: (s[0], -s[1]))
    out, stack = [], []
    for s, e, name in spans:
        while stack and stack[-1][1] <= s:
            stack.pop()
        assert not stack or e <= stack[-1][1], (name, "crosses", stack[-1])
        out.append((s, e, name, stack[-1][2] if stack else None))
        stack.append((s, e, name))
    return out


def _inside(spans, outer):
    return [x for x in spans if outer[0] <= x[0] and x[1] <= outer[1]
            and x is not outer]


def test_scope_makes_no_record_function_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span was recorded with no profiler on")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    first, second = profiling.scope("a"), profiling.scope("b")
    assert first is second  # one shared no-op
    with first, second:
        pass


@pytest.mark.parametrize("strategy", ["greedy", "beam"])
def test_transcribe_many_span_tree(transcriber, strategy):
    waves = _streams()
    full, tails = _windows(transcriber.cfg, waves)
    assert full == 3 and tails == 2  # the second batch is padded
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        transcriber.transcribe_many(waves, options=_options(strategy))
    spans = _spans(prof)
    names = [x[2] for x in spans]
    assert set(names) == set(PARENTS)
    for s, e, name, parent in spans:
        assert parent in PARENTS[name] or (
            # beam search reads its stop rule once before the first step
            strategy == "beam" and name == "whisper.decode.sync"
            and parent == "whisper.decode.prefill"), (name, parent)
    assert names.count("whisper.transcribe_many") == 1
    assert names.count("whisper.window") == 1
    assert names.count("whisper.batch") == math.ceil(full / BATCH)
    assert names.count("whisper.batch.stack") == math.ceil(full / BATCH)
    assert names.count("whisper.readback") == math.ceil(full / BATCH)
    assert names.count("whisper.tail") == tails
    assert names.count("whisper.stitch") == len(waves)
    decodes = [x for x in spans if x[2] == "whisper.decode"]
    assert len(decodes) == math.ceil(full / BATCH) + tails
    for d in decodes:
        inner = _inside(spans, d)
        steps = [x for x in inner if x[2] == "whisper.decode.step"]
        assert 1 <= len(steps) <= MAX_DEPTH
        assert sum(x[2] == "whisper.decode.prefill" for x in inner) == 1
        # one blocking read a step, but none in a step that ends the loop
        # on length (the last of MAX_DEPTH)
        on_length = len(steps) == MAX_DEPTH
        per_step = [sum(y[2] == "whisper.decode.sync"
                        for y in _inside(spans, x)) for x in steps]
        assert per_step == [1] * (len(steps) - on_length) + [0] * on_length
        if strategy == "beam":
            prefill = next(x for x in inner
                           if x[2] == "whisper.decode.prefill")
            assert [y[2] for y in _inside(spans, prefill)] == [
                "whisper.decode.sync"]


@pytest.mark.parametrize("strategy", ["greedy", "beam"])
def test_tokens_equal_with_the_profiler_on_and_off(transcriber, strategy):
    waves = _streams()
    opt = _options(strategy)
    off = transcriber.transcribe_many(waves, options=opt)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on = transcriber.transcribe_many(waves, options=opt)
    assert on == off
    assert all(tokens for _, tokens in off)
