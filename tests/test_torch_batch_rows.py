"""`_BatchRows`, the batch builder of the port's batched paths, on the CPU.

A batch of full windows is cut from one device copy of the stretches of
the streams that its windows cover. It must equal, bit for bit, what the
host built before: `np.stack` of the windows, a short batch padded with
its first window (tests/host_stack_batches.py), for every layout a batch
takes -- windows of several streams, a short last batch, VAD-skipped
windows, the scattered windows a ladder rung decodes again, and a dp rank's
share of a batch -- whether the builder's host buffer is new, or left by a
smaller or a larger batch. And `transcribe_many` gives the tokens of the
host-stacked path. Torch only.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from whisper_tpu_torch.config import tiny_test_config
from whisper_tpu_torch.ops.audio import max_waveform_samples
from whisper_tpu_torch.params import init_params
from whisper_tpu_torch.pipeline import batch as TB
from whisper_tpu_torch.pipeline import transcribe as TT
from whisper_tpu_torch.text.tokenizer import (WhisperTokenizer,
                                              build_test_tokenizer_json)

from host_stack_batches import host_batch, host_stack_transcribe_many
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

N, OVERLAP = 1000, 150  # window and overlap samples of the builder cases


def _streams(*n_windows):
    """Streams of random samples that `window_waveform` cuts into the given
    numbers of full windows, each with a short tail; their windows'
    starts."""
    shift = N - OVERLAP
    rng = np.random.default_rng(len(n_windows))
    waves = [rng.standard_normal((k - 1) * shift + N + 300)
             .astype(np.float32) for k in n_windows]
    starts = [[s for s, e in TT.window_waveform(w, 16000, N, OVERLAP)
               if e - s == N] for w in waves]
    assert [len(s) for s in starts] == list(n_windows)
    return waves, starts


# (stream lengths in windows, the batch's (stream, window)s, batch size)
CASES = {
    "streams": ((3, 4, 2), [(0, 1), (0, 2), (1, 0), (1, 1), (1, 2), (1, 3),
                            (2, 0)], 7),
    "partial": ((5,), [(0, 3), (0, 4)], 4),
    "vad_gaps": ((8,), [(0, 0), (0, 1), (0, 4), (0, 5), (0, 7)], 5),
    "ladder": ((6, 3), [(0, 0), (0, 4), (1, 1), (1, 2)], 6),
    "dp2_rank": ((4, 3), [(0, 1), (0, 2), (0, 3), (1, 0)], 4),
}


@pytest.mark.parametrize("before", ["none", "smaller", "larger"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_batch_rows_equal_the_host_stack(case, before, monkeypatch):
    """The batch equals the host stack, also from a builder whose host
    buffer an earlier batch of one row, or of every window, sized and
    filled."""
    lengths, group, batch_size = CASES[case]
    waves, starts = _streams(*lengths)
    rows = [(waves[s], starts[s][w]) for s, w in group]
    want = host_batch([waves[s][starts[s][w]:starts[s][w] + N]
                       for s, w in group], batch_size)
    builder = TB._BatchRows("cpu", N)
    if before != "none":
        every = [(wave, start) for wave, st in zip(waves, starts)
                 for start in st[::-1]]  # no two rows share a stretch
        earlier = every[:1] if before == "smaller" else every
        builder.batch(earlier, len(earlier))
    got = builder.batch(rows, batch_size)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    if case != "dp2_rank":
        return
    # rank 1 of dp=2 decodes rows [2, 4) of the batch
    seen = []
    fake = SimpleNamespace(
        mesh=SimpleNamespace(shape={"dp": 2, "tp": 1}, dp_rank=1),
        _decode_rows=lambda w, *a: seen.append(w.clone()) or (w[:, :1],))
    monkeypatch.setattr(TB, "dp_all_gather", lambda out, mesh: out)
    TB.BatchTranscriber._decode_batch(fake, got, None, 0, None)
    np.testing.assert_array_equal(seen[0].numpy(), want[2:4])


def test_stretches_cross_the_bus_once():
    """Overlapping windows of a stream are staged as one stretch: the host
    buffer holds each sample once, and only as many as the rows cover."""
    waves, starts = _streams(4, 2)
    rows = ([(waves[0], s) for s in starts[0]]
            + [(waves[1], starts[1][1])])
    audio, offsets = TB._BatchRows("cpu", N)._stage(rows)
    shift = N - OVERLAP
    assert audio.numel() == 3 * shift + N + N
    assert offsets == [0, shift, 2 * shift, 3 * shift, 3 * shift + N]


# -------------------------------------------------------- transcribe_many

ENC_CTX = 96


@pytest.fixture(scope="module")
def bt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("batch_rows") / "tokenizer.json")
    build_test_tokenizer_json(path)
    tok = WhisperTokenizer(path)
    cfg = tiny_test_config(n_state=32, n_head=2, n_layer=2,
                           n_vocab=tok.vocab_size, n_audio_ctx=ENC_CTX,
                           n_text_ctx=48)
    params = init_params(cfg, torch.Generator().manual_seed(7))
    return TB.BatchTranscriber(params, cfg, tok, batch_size=3, device="cpu")


def _speech(n_windows, seed, silent_window=None):
    """Speech-shaped audio of `n_windows` full windows and a tail at a
    0.15 s overlap; `silent_window`'s samples are zero."""
    n_window = max_waveform_samples(ENC_CTX - 10)
    shift = n_window - int(16000 * 0.15)
    n = (n_windows - 1) * shift + n_window + 5000
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    x = (0.3 * np.sin(2 * np.pi * (200.0 + 20 * seed) * t)
         + 0.1 * rng.standard_normal(n))
    x = (x * (0.5 + 0.5 * np.sign(np.sin(2 * np.pi * 1.3 * t))))
    if silent_window is not None:
        a = silent_window * shift
        x[a:a + n_window] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("kw", [dict(), dict(vad=True),
                                dict(strategy="beam", beam_size=2)],
                         ids=["greedy", "vad", "beam"])
def test_transcribe_many_equals_the_host_stack_path(bt, kw, monkeypatch):
    """Three streams (4, 2 and 2 full windows, the first with a silent
    window that VAD skips, the second read-only, the last a reversed view):
    batches of 3 cross streams, the last is short; the tokens are the
    host-stacked path's, and the encoder takes the batches as tensors."""
    vad = kw.get("vad", False)
    waves = [_speech(4, 3, silent_window=2 if vad else None),
             _speech(2, 4), _speech(2, 5)[::-1]]  # negative strides
    waves[1].flags.writeable = False
    opt = TT.DecodeOptions(max_depth=8, chunk_overlap_seconds=0.15, **kw)
    kinds, staged = [], []
    real = TT.Transcriber._encode_windows
    real_stage = TB._BatchRows._stage

    def spy(self, w, *a, **k):
        kinds.append(type(w))
        return real(self, w, *a, **k)

    def stage_spy(self, rows):
        # torch wraps only writeable memory without a warning
        staged.extend(w.flags.writeable and w.flags.c_contiguous
                      for w, _ in rows)
        return real_stage(self, rows)

    monkeypatch.setattr(TT.Transcriber, "_encode_windows", spy)
    monkeypatch.setattr(TB._BatchRows, "_stage", stage_spy)
    want = host_stack_transcribe_many(bt, waves, opt)
    assert kinds == [np.ndarray] * 3
    kinds.clear()
    got = bt.transcribe_many(waves, options=opt)
    assert got == want and all(tokens for _, tokens in got)
    assert kinds == [torch.Tensor] * 3
    assert staged and all(staged)
    results = bt._decode_windows(waves, 16000, opt)[0]
    assert ((0, 2) in results) is not vad
