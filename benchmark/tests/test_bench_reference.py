"""The plain reference against the port's plain path (attention="xla",
float32) at a tiny configuration on the CPU: the log-mel frontend, the
encoder and the teacher-forced decoder. The reference imports nothing of
the port; this test holds the two against each other."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bench_tiny import tiny_cell
from benchmark import harness
from benchmark import traffic as tr
from benchmark.reference import whisper as ref
from benchmark.weights import make_weights

# float32 on both sides, other orders of summation: relative L2 error
RTOL = 1e-5


def rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def setup():
    cell = tiny_cell("large-v3-turbo.archive-greedy")
    cfg = cell.config
    weights = make_weights(cfg, 2 ** 31 + 5, "cpu", dtype=torch.float32)
    geo = tr.geometry(cfg, cell.traffic)
    wave = tr.audio(geo.window + geo.shift, 2 ** 31 + 5, 0, 0, "cpu")
    windows = [wave[s:e] for s, e in tr.windows(len(wave), geo)]
    return cell, weights, windows


def test_mel_filters_match_port():
    from whisper_tpu_torch.ops.audio import mel_filters

    for n_mels in (80, 128):
        ours = torch.from_numpy(ref.mel_filters(n_mels)).float()
        np.testing.assert_allclose(ours.numpy(), mel_filters(n_mels=n_mels).numpy(),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("which", [0, 2])  # a full window and the tail
def test_log_mel_matches_port(setup, which):
    from whisper_tpu_torch.ops.audio import prep_audio

    cell, _, windows = setup
    cfg, pad = cell.config, cell.traffic["options"]["padding"]
    wave = windows[which][None]
    got = ref.log_mel(wave, cfg["num_mel_bins"], cfg["max_source_positions"], pad)
    port = prep_audio(wave, per_sample_max=True, n_mels=cfg["num_mel_bins"])
    port = F.pad(port[:, :, :cfg["max_source_positions"] - pad], (0, pad))
    assert got.shape == port.shape
    assert rel(got, port) < RTOL


def test_encoder_and_decoder_match_port(setup):
    from whisper_tpu_torch.models.whisper import decoder_forward, encoder_forward
    from whisper_tpu_torch.params import ParamTree

    cell, weights, windows = setup
    cfg = cell.config
    pcfg = harness.program_config(cfg)  # attention="xla": the plain path
    params = ParamTree(weights)
    mel = ref.log_mel(torch.stack(windows[:2]), cfg["num_mel_bins"],
                      cfg["max_source_positions"], 10)
    enc = ref.encoder(weights, mel, cfg["encoder_attention_heads"])
    port_enc = encoder_forward(params, mel, pcfg)
    assert rel(enc, port_enc) < RTOL
    ids = torch.tensor([cfg["tokens"]["prompt_en_transcribe_notimestamps"]
                        + [11, 220, 40000, 7]] * 2)
    logits = ref.decoder_logits(weights, ids, enc, cfg["decoder_attention_heads"])
    port_logits = decoder_forward(params, ids, port_enc, pcfg)
    assert rel(logits, port_logits) < RTOL
    # the zeroed EOT row makes the EOT logit exactly 0
    assert float(logits[..., cfg["tokens"]["eot"]].abs().max()) == 0.0


def test_beam_search_matches_port(setup):
    """The reference's beam search gives the port's plain-path beam
    search's hypotheses, and its sums are the teacher-forced ones."""
    from whisper_tpu_torch.decode.beam import beam_search_batched
    from whisper_tpu_torch.params import ParamTree

    cell, weights, windows = setup
    cfg = cell.config
    tok = cfg["tokens"]
    prompt = tok["prompt_en_transcribe_notimestamps"]
    mel = ref.log_mel(torch.stack(windows[:2]), cfg["num_mel_bins"],
                      cfg["max_source_positions"], 10)
    enc = ref.encoder(weights, mel, cfg["encoder_attention_heads"])
    got, score = ref.beam_search(weights, enc, prompt,
                                 cfg["decoder_attention_heads"], 5, 12,
                                 tok["first_special"], 5)
    mask = torch.where(torch.arange(cfg["vocab_size"]) >= tok["first_special"],
                       float("-inf"), 0.0)
    port = beam_search_batched(ParamTree(weights), enc, torch.tensor(prompt),
                               harness.program_config(cfg), eot_id=tok["eot"],
                               suppress_mask=mask, beam_size=5, max_depth=12,
                               suppress_until_len=5)
    assert torch.equal(port[0][:, len(prompt):len(prompt) + 12], got)
    np.testing.assert_allclose(score.numpy(), port[2].numpy(), rtol=1e-5)
    ids = torch.cat([torch.tensor([prompt] * 2), got[:, :-1]], 1)
    logits = ref.decoder_logits(weights, ids, enc,
                                cfg["decoder_attention_heads"])
    from benchmark import check

    tf = check.sequence_logp(logits[:, len(prompt) - 1:], got, cfg, cell.traffic)
    np.testing.assert_allclose(tf.numpy(), score.numpy(), rtol=1e-6)


@pytest.mark.parametrize("min_overlaps", [0, 1, 3])
def test_stitch_matches_port(min_overlaps):
    """The reference splice against the port's `find_chunk_overlap` loop
    on windows whose ends repeat, partly, at the next one's start."""
    from whisper_tpu_torch.pipeline.transcribe import find_chunk_overlap

    from benchmark.reference import stitch

    rng = np.random.default_rng(min_overlaps)
    windows, last = [], None
    for i in range(40):
        new = rng.integers(0, 6, 30).tolist()
        if last and i % 3:
            k = int(rng.integers(1, 12))
            new[:k] = last[-k:]
        last = new
        windows.append(None if i % 11 == 5 else new)
    port = []
    for new in windows:
        if new is None:
            continue
        cut = find_chunk_overlap(port, new, 8, min_overlaps)
        port = port[:cut[0]] + new[cut[1]:] if cut else port + new
    assert stitch.stitch(windows, 8, min_overlaps) == port
