"""The port's `finetune` command and train-state checkpoints on the CPU:
`cli.py finetune --device cpu` against the JAX CLI on the same dump and
manifest (losses, the exported checkpoint, `--resume`), its error exits,
and save -> restore -> continue against an uninterrupted run."""

import os
import re
import wave as wave_mod

import jax
import numpy as np
import pytest
import torch

from whisper_tpu import cli as jax_cli
from whisper_tpu.config import tiny_test_config as jax_tiny_config
from whisper_tpu.io import checkpoint as jax_checkpoint
from whisper_tpu.io import npy_tree
from whisper_tpu.models import whisper as JM
from whisper_tpu_torch import cli as torch_cli
from whisper_tpu_torch.config import tiny_test_config
from whisper_tpu_torch.io import checkpoint as torch_checkpoint
from whisper_tpu_torch.params import numpy_tree, trainable
from whisper_tpu_torch.text.tokenizer import (WhisperTokenizer,
                                              build_test_tokenizer_json)
from whisper_tpu_torch.training import checkpointing as ckpt
from whisper_tpu_torch.training import data as TD
from whisper_tpu_torch.training import train as TT

# printed losses of the two CLIs (4 decimals; f32 steps in another order)
LOSS_RTOL = 1e-4
# the exported params against the JAX CLI's, relative L2 per leaf, the key
# bias apart (tests/test_torch_training.py's K_BIAS note)
PARAM_RTOL = 1e-4
CFG_KW = dict(n_state=32, n_head=2, n_layer=2, n_audio_ctx=64,
              n_text_ctx=32)
STEP = re.compile(r"^step (\d+): loss (\S+) acc (\S+) grad_norm (\S+)$")


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A 2-layer JAX checkpoint as an npy dump, the synthetic tokenizer,
    four 16 kHz clips and a manifest with one transcript."""
    d = tmp_path_factory.mktemp("finetune")
    build_test_tokenizer_json(str(d / "tokenizer.json"))
    tok = WhisperTokenizer(str(d / "tokenizer.json"))
    cfg = jax_tiny_config(n_vocab=tok.vocab_size, **CFG_KW)
    params = jax.tree.map(np.asarray,
                          JM.init_params(jax.random.PRNGKey(0), cfg))
    npy_tree.save_whisper(params, cfg, str(d / "dump"))
    rng = np.random.default_rng(0)
    lines = []
    for i in range(4):
        with wave_mod.open(str(d / f"a{i}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((rng.standard_normal(2000) * 3000)
                          .astype(np.int16).tobytes())
        lines.append(f"a{i}.wav\thello world")
    (d / "train.tsv").write_text("\n".join(lines) + "\n")
    return d, params


def _steps(out: str):
    return [tuple(float(x) for x in m.groups()[1:]) + (int(m.group(1)),)
            for m in map(STEP.match, out.splitlines()) if m]


def _run(main, argv, capsys):
    rc = main(argv)
    captured = capsys.readouterr()
    return rc, captured.out, captured.err


FLAGS = ["--steps", "4", "--batch-size", "2", "--lr", "1e-3", "--warmup",
         "1", "-v"]


@pytest.fixture(scope="module")
def cli_runs(workdir):
    """Both CLIs over the same dump and manifest; the port's with
    `--save-every 2`, then `--resume` of its step-4 train state to step 6
    (run once here, read by the tests below)."""
    d, _ = workdir
    cwd = os.getcwd()
    os.chdir(d)
    try:
        from contextlib import redirect_stderr, redirect_stdout
        from io import StringIO

        def run(main, argv):
            out, err = StringIO(), StringIO()
            with redirect_stdout(out), redirect_stderr(err):
                rc = main(argv)
            return rc, out.getvalue(), err.getvalue()

        base = ["finetune", "dump", "train.tsv", "en"] + FLAGS
        return {
            "jax": run(jax_cli.main, base + ["--out", "tuned_jax"]),
            "torch": run(torch_cli.main, base + [
                "--out", "tuned", "--device", "cpu", "--save-every", "2"]),
            "resume": run(torch_cli.main, [
                "finetune", "dump", "train.tsv", "en", "--steps", "6",
                "--batch-size", "2", "--lr", "1e-3", "--warmup", "1", "-v",
                "--out", "resumed", "--device", "cpu", "--resume",
                "tuned.ckpt"])}
    finally:
        os.chdir(cwd)


def test_finetune_losses_match_the_jax_cli(cli_runs):
    (jrc, jout, jerr), (trc, tout, terr) = cli_runs["jax"], cli_runs["torch"]
    assert jrc == 0 and trc == 0, (jerr, terr)
    want, got = _steps(jout), _steps(tout)
    assert [s[-1] for s in got] == [s[-1] for s in want] == [0, 1, 2, 3]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0], w[0], rtol=LOSS_RTOL)
        assert np.isfinite(g[0])
        assert abs(g[1] - w[1]) <= 1e-3 and abs(g[2] - w[2]) <= 2e-3
    # 4 identical transcripts: the loss falls, as the JAX CLI test expects
    assert got[-1][0] < got[0][0]
    assert "Loaded 4 examples" in tout.splitlines()[0]
    assert re.search(r"^Saved tuned\.safetensors \+ tuned\.cfg \(4 steps in "
                     r"[0-9.]+s\)$", tout, re.M)


def test_exported_checkpoint_loads_in_both_packages(cli_runs, workdir):
    d, start = workdir
    assert cli_runs["torch"][0] == 0
    path = str(d / "tuned.safetensors")
    tp, tcfg = torch_checkpoint.load_params(path)
    jp, jcfg = jax_checkpoint.load_params(path)
    assert tcfg.to_cfg_dict() == jcfg.to_cfg_dict()
    assert jcfg.decoder_ctx_size == CFG_KW["n_text_ctx"]
    assert torch_checkpoint.load_params(str(d / "tuned"))[1] == tcfg
    want, _ = jax_checkpoint.load_params(str(d / "tuned_jax.safetensors"))
    flat_t = torch_checkpoint.flatten_params(tp)
    flat_j = torch_checkpoint.flatten_params(
        jax.tree.map(np.asarray, jp))
    flat_w = torch_checkpoint.flatten_params(jax.tree.map(np.asarray, want))
    assert set(flat_t) == set(flat_j) == set(flat_w)
    for name, a in flat_t.items():
        np.testing.assert_array_equal(a, flat_j[name])
        if name.endswith(("qkv_b", "cross_kv_b")):
            continue  # the key bias: rounding noise under AdamW
        rel = np.linalg.norm(a - flat_w[name]) / np.linalg.norm(flat_w[name])
        assert rel <= PARAM_RTOL, name
    assert not np.allclose(tp["decoder"]["tok_emb"],
                           start["decoder"]["tok_emb"])


def test_resume_restarts_the_batches_from_the_seed(cli_runs, workdir):
    """`--resume` of the step-4 train state: "Resumed at step 4", steps 4
    and 5 only, and their batches those of steps 0 and 1 (the iterator
    restarts from --seed, as in JAX): the resumed step 4 sees step 0's
    batch at step 4's params, so its loss is that of a state from
    continuing training -- checked against the library below."""
    d, _ = workdir
    rc, out, err = cli_runs["resume"]
    assert rc == 0, err
    assert out.splitlines()[1] == "Resumed at step 4"
    steps = _steps(out)
    assert [s[-1] for s in steps] == [4, 5]
    assert all(np.isfinite(s[0]) for s in steps)
    assert "(2 steps in" in out
    # the same as restoring the file and stepping on the seed's first batch
    tok = WhisperTokenizer(str(d / "tokenizer.json"))
    cfg = tiny_test_config(n_vocab=tok.vocab_size, **CFG_KW)
    examples = TD.load_examples(
        [(str(d / f"a{i}.wav"), "hello world") for i in range(4)])
    opt = TT.make_optimizer(learning_rate=1e-3, warmup_steps=1,
                            total_steps=6)
    params, _ = torch_checkpoint.load_params(str(d / "dump"))
    state = ckpt.restore_train_state(
        str(d / "tuned.ckpt"), TT.init_train_state(trainable(params), opt))
    assert state.step == 4 and state.opt_state.count == 4
    batch = next(TD.iter_batches(examples, tok, cfg, 2, seed=0))
    _, metrics = TT.make_train_step(cfg, opt)(state, batch)
    assert f"{float(metrics['loss']):.4f}" == f"{steps[0][0]:.4f}"


def test_finetune_error_exits(workdir, capsys, monkeypatch):
    d, _ = workdir
    monkeypatch.chdir(d)
    rc, out, err = _run(torch_cli.main, [
        "finetune", "dump", "train.tsv", "--steps", "3", "--batch-size", "2",
        "--lr", "1e30", "--warmup", "0", "--device", "cpu", "--out", "x"],
        capsys)
    assert rc == 1 and "non-finite loss" in err
    assert not os.path.exists("x.safetensors")
    rc, _, err = _run(torch_cli.main, [
        "finetune", "missing", "train.tsv", "--device", "cpu"], capsys)
    assert rc == 1 and "Failed to load whisper model file" in err
    rc, _, err = _run(torch_cli.main, [
        "finetune", "dump", "nothere.tsv", "--device", "cpu"], capsys)
    assert rc == 1 and "Failed to load dataset" in err
    if not torch.cuda.is_available():
        rc, _, err = _run(torch_cli.main,
                          ["finetune", "dump", "train.tsv"], capsys)
        assert rc == 1 and "No CUDA device" in err
    assert torch_cli.main(["nothing"]) == 2
    assert "finetune <model> <dataset>" in capsys.readouterr().err


def test_save_restore_continue_is_bit_equal(workdir, tmp_path):
    """2 steps, save, restore (into a fresh state, and from the file
    alone), 2 more steps each: params, moments, count and metrics
    bit-equal to 4 uninterrupted steps; the export's bytes too."""
    d, start = workdir
    tok = WhisperTokenizer(str(d / "tokenizer.json"))
    cfg = tiny_test_config(n_vocab=tok.vocab_size, **CFG_KW)
    examples = TD.load_examples(
        [(str(d / f"a{i}.wav"), "hello world") for i in range(4)])
    batches = list(TD.iter_batches(examples, tok, cfg, 2, seed=0, epochs=2))
    opt = TT.make_optimizer(learning_rate=1e-3, warmup_steps=1,
                            total_steps=4)
    step = TT.make_train_step(cfg, opt)

    whole = TT.init_train_state(trainable(start), opt)
    whole_metrics = []
    for b in batches:
        whole, m = step(whole, b)
        whole_metrics.append(m)
    part = TT.init_train_state(trainable(start), opt)
    for b in batches[:2]:
        part, _ = step(part, b)
    path = str(tmp_path / "state.ckpt")
    ckpt.save_train_state(path, part)
    for target in (TT.init_train_state(trainable(start), opt), None):
        part = ckpt.restore_train_state(path, target)
        assert part.step == 2 and part.opt_state.count == 2
        for i, b in enumerate(batches[2:], 2):
            part, m = step(part, b)
            for key, v in m.items():
                assert torch.equal(v, whole_metrics[i][key]), key
        assert part.step == whole.step == 4
        got = dict(part.params.named_parameters())
        for name, p in whole.params.named_parameters():
            assert torch.equal(got[name], p), name
            for moment in ("mu", "nu"):
                assert torch.equal(getattr(part.opt_state, moment)[name],
                                   getattr(whole.opt_state, moment)[name])
        assert part.opt_state.count == whole.opt_state.count == 4
    # export: the same bytes through either tree
    ckpt.export_params(part, cfg, str(tmp_path / "a.safetensors"))
    torch_checkpoint.save_safetensors(numpy_tree(whole.params), cfg,
                                      str(tmp_path / "b.safetensors"))
    assert ((tmp_path / "a.safetensors").read_bytes()
            == (tmp_path / "b.safetensors").read_bytes())


def test_restore_refuses_a_mismatched_target(workdir, tmp_path):
    _, start = workdir
    opt = TT.make_optimizer()
    state = TT.init_train_state(trainable(start), opt)
    ckpt.save_train_state(str(tmp_path / "s.ckpt"), state)
    other = {k: v for k, v in start.items() if k == "encoder"}
    with pytest.raises(ValueError, match="do not match"):
        ckpt.restore_train_state(str(tmp_path / "s.ckpt"),
                                 TT.init_train_state(trainable(other), opt))
