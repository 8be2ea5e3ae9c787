"""A run driven end to end on the CPU at a tiny size (the look for a card
skipped), first sound, then with the timed path broken underneath: a
token altered where it is produced, an answer altered where it is
produced (the splice of overlapping windows cutting one token late), and
half of each batch left out (its rows answered with the other half's).
Each fault must make `correct` false. The remaining faults of the
contract's list do not exist here: nothing trains (a step that returns
its state unchanged) and a cell runs on one card (the exchange between
cards).

Beam search is held too, on its traffic with the turbo configuration,
though BENCHMARK.json lists no beam cell (no number of it separates the
program from its control on the card, PERF.md): at this size the float32
program reads 0 on every number, so BEAM_LIMITS holds it to little above
that."""

import time

import pytest
import torch

from bench_tiny import tiny_cell
from benchmark import harness

SEED = 2 ** 31 + 77
BEAM_LIMITS = {"numbers": {"widest_gap": {"limit": 0.01},
                           "mean_deficit": {"limit": 0.001}}}


def run(name, tmp_path, seconds=0.1):
    # beam search's answers depend on the audio enough for a swapped
    # window to show from 4 layers on
    cell = tiny_cell(name, layers=4 if "beam" in name else 2)
    if not cell.limits["numbers"]:
        cell.limits = BEAM_LIMITS
    result, lines = harness.run_cell(cell, SEED, seconds, False, "cpu",
                                     time.perf_counter(), cache=tmp_path)
    return result


@pytest.mark.parametrize("name", ["large-v3-turbo.archive-greedy",
                                  "large-v3-turbo.archive-beam5"])
def test_sound_run_is_correct(name, tmp_path):
    result = run(name, tmp_path)
    assert result["correct"], result["checks"]
    assert result["attempted"] == 2 and result["failed"] == 0
    assert list(result["metrics"]) == ["xrt", "setup_s"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("name,fn", [("large-v3-turbo.archive-greedy", "greedy_decode"),
                                     ("large-v3-turbo.archive-beam5", "beam_search_batched")])
def test_altered_token_is_caught(name, fn, monkeypatch, tmp_path):
    from whisper_tpu_torch.pipeline import batch

    real = getattr(batch, fn)

    def altered(*args, **kwargs):
        out = real(*args, **kwargs)
        tokens = out[0]
        tokens[0, 7] = (tokens[0, 7] + 1) % 50000
        return out

    monkeypatch.setattr(batch, fn, altered)
    result = run(name, tmp_path)
    assert not result["correct"]
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("name", ["large-v3-turbo.archive-greedy",
                                  "large-v3-turbo.archive-beam5"])
def test_altered_splice_is_caught(name, monkeypatch, tmp_path):
    from whisper_tpu_torch.pipeline import batch

    real = batch.find_chunk_overlap
    spliced = []

    def late(prev, curr, *args):
        cut = real(prev, curr, *args)
        spliced.append(cut is not None)
        return None if cut is None else (cut[0] + 1, cut[1])

    monkeypatch.setattr(batch, "find_chunk_overlap", late)
    result = run(name, tmp_path)
    assert any(spliced)  # the traffic's windows do overlap in tokens
    assert not result["correct"]
    assert result["checks"]["wrong_answers"]["value"] > 0


@pytest.mark.parametrize("name", ["large-v3-turbo.archive-greedy",
                                  "large-v3-turbo.archive-beam5"])
def test_half_the_batch_left_out_is_caught(name, monkeypatch, tmp_path):
    from whisper_tpu_torch.pipeline.batch import BatchTranscriber

    real = BatchTranscriber._decode_batch

    def half(self, waves, *args, **kwargs):
        n = len(waves) // 2
        out = real(self, waves[:n], *args, **kwargs)
        return tuple(torch.cat([torch.as_tensor(o)] * 2).numpy() for o in out)

    monkeypatch.setattr(BatchTranscriber, "_decode_batch", half)
    result = run(name, tmp_path)
    assert not result["correct"]
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
