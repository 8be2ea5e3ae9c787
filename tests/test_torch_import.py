"""The PyTorch port stands alone: it imports without jax, triton, any CUDA
build or any module of the JAX package `whisper_tpu`, and its own copies
of the JAX package's config and tokenizer agree with the originals.

The import checks run in a fresh interpreter: the test process itself has
jax loaded (conftest), so `sys.modules` here says nothing.
"""

import dataclasses
import os
import re
import subprocess
import sys
import wave as wave_mod
from pathlib import Path

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = ("tiny", "tiny.en", "base", "base.en", "small", "small.en",
           "medium", "medium.en", "large", "large-v2", "large-v3",
           "large-v3-turbo")


def _run(code: str, cwd: str = REPO) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env, cwd=cwd)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def _port_modules():
    root = Path(REPO)
    return sorted(
        ".".join(p.relative_to(root).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in (root / "whisper_tpu_torch").rglob("*.py"))


@pytest.mark.parametrize("modules", [
    "whisper_tpu_torch, whisper_tpu_torch.pipeline.transcribe",
    "whisper_tpu_torch.cli",
    "whisper_tpu_torch.models.whisper, whisper_tpu_torch.decode.greedy",
    "whisper_tpu_torch.pipeline.batch, "
    "whisper_tpu_torch.ops.kernels.dequant_matmul",
    "whisper_tpu_torch.align, whisper_tpu_torch.io.convert_pt, "
    "whisper_tpu_torch.io.mpk, whisper_tpu_torch.decode.host_beam",
    "whisper_tpu_torch.decode.speculative, "
    "whisper_tpu_torch.pipeline.streaming, whisper_tpu_torch.serve, "
    "whisper_tpu_torch.utils.logging",
])
def test_import_leaves_out_jax_triton_and_cuda_build(modules):
    out = _run(
        f"import sys, {modules}\n"
        "from whisper_tpu_torch.ops.kernels import _build\n"
        "print(sorted(m for m in ('jax', 'triton') if m in sys.modules), "
        "_build._lib is None)\n")
    assert out.split() == ["[]", "True"]


@pytest.fixture(scope="module")
def tiny_cli_dir(tmp_path_factory):
    """A 2-layer random npy-dump checkpoint, the same weights as a bare
    OpenAI state dict (`bare.pt`), the synthetic tokenizer and 0.5 s of
    audio, written with the JAX package in this process."""
    import jax
    import torch

    from test_convert_pt import _openai_sd

    from whisper_tpu.config import tiny_test_config
    from whisper_tpu.io import npy_tree
    from whisper_tpu.models import whisper as JM
    from whisper_tpu.text.tokenizer import (WhisperTokenizer,
                                            build_test_tokenizer_json)

    d = tmp_path_factory.mktemp("standalone")
    build_test_tokenizer_json(str(d / "tokenizer.json"))
    tok = WhisperTokenizer(str(d / "tokenizer.json"))
    cfg = tiny_test_config(n_state=32, n_head=2, n_layer=2,
                           n_vocab=tok.vocab_size, n_audio_ctx=96,
                           n_text_ctx=48)
    params = jax.tree.map(np.asarray,
                          JM.init_params(jax.random.PRNGKey(7), cfg))
    npy_tree.save_whisper(params, cfg, str(d / "dump"))
    torch.save(_openai_sd(params), str(d / "bare.pt"))
    x = 0.3 * np.sin(2 * np.pi * 220.0 * np.arange(8000) / 16000.0)
    with wave_mod.open(str(d / "audio.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((x * 20000).astype(np.int16).tobytes())
    return d


def test_port_runs_with_jax_and_the_jax_package_blocked(tiny_cli_dir):
    """With `whisper_tpu` and `jax` made unimportable, every port module
    imports and the CLI transcribes on the CPU (beam search, the default),
    one file with `transcribe` and two with `transcribe-many`."""
    out = _run(
        "import importlib, sys\n"
        "sys.modules['whisper_tpu'] = None\n"
        "sys.modules['jax'] = None\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "from whisper_tpu_torch.cli import main\n"
        "rc = main(['transcribe', 'dump', 'audio.wav', 'en', 'out.txt', "
        "'--max-depth', '4', '--device', 'cpu'])\n"
        "print('RC', rc)\n"
        "rc = main(['transcribe-many', 'dump', 'en', 'many', 'audio.wav', "
        "'audio.wav', '--batch-size', '2', '--device', 'cpu'])\n"
        "print('RC', rc)\n", cwd=str(tiny_cli_dir))
    assert [line for line in out.splitlines() if line.startswith("RC")] == [
        "RC 0", "RC 0"], out
    assert (tiny_cli_dir / "out.txt").exists()
    assert (tiny_cli_dir / "many" / "audio.txt").exists()


def test_convert_runs_with_jax_and_the_jax_package_blocked(tiny_cli_dir):
    """With `whisper_tpu` and `jax` unimportable, `convert` (with the Burn
    record) and `convert-pt` (with the npy dump tree) write their files on
    the host, and the converted checkpoint transcribes on the CPU."""
    out = _run(
        "import sys\n"
        "sys.modules['whisper_tpu'] = None\n"
        "sys.modules['jax'] = None\n"
        "from whisper_tpu_torch.cli import main\n"
        "print('RC', main(['convert', 'dump', '--out', 'conv', '--mpk']))\n"
        "print('RC', main(['convert-pt', 'bare.pt', 'frompt', "
        "'--dump-tree']))\n"
        "print('RC', main(['transcribe', 'conv', 'audio.wav', 'en', "
        "'conv.txt', '--greedy', '--max-depth', '4', '--device', "
        "'cpu']))\n", cwd=str(tiny_cli_dir))
    assert [line for line in out.splitlines() if line.startswith("RC")] == [
        "RC 0"] * 3, out
    for name in ("conv.safetensors", "conv.cfg", "conv.mpk.gz",
                 "frompt.safetensors", "frompt.cfg", "conv.txt",
                 "frompt/encoder/conv1/weight.npy"):
        assert (tiny_cli_dir / name).exists(), name


def test_no_port_file_imports_the_jax_package():
    pattern = re.compile(r"^\s*(from|import)\s+whisper_tpu(\.|\s|$)")
    jax_pattern = re.compile(r"^\s*(from|import)\s+jax(\.|\s|$)")
    files = [*Path(REPO, "whisper_tpu_torch").rglob("*.py"),
             Path(REPO, "chip_smoke.py"),
             *(Path(REPO, "tools", f) for f in (
                 "profile_torch_decode.py", "compare_attention_kernels.py",
                 "sweep_k3g_splits.py", "int4_path_gap.py"))]
    found = [f"{f}:{i}" for f in files
             for i, line in enumerate(f.read_text().splitlines(), 1)
             if pattern.match(line) or jax_pattern.match(line)]
    assert len(files) > 20 and found == []


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("name", PRESETS)
def test_port_preset_matches_the_jax_package(name):
    from whisper_tpu import config as jcfg
    from whisper_tpu_torch import config as tcfg

    got, want = tcfg.preset(name), jcfg.preset(name)
    for field, value in _fields(got).items():
        other = getattr(want, field)
        if field == "knobs":  # the port keeps the knobs it has kernels for;
            # flash_impl is the JAX env override's default, "bsd"
            assert _fields(value) == {"int8_impl": other.int8_impl,
                                      "flash_impl": "bsd"}
        elif dataclasses.is_dataclass(value):
            assert _fields(value) == _fields(other), (name, field)
        else:
            assert value == other, (name, field)
    assert got.to_cfg_dict() == want.to_cfg_dict()
    assert tcfg.SAMPLE_RATE == jcfg.SAMPLE_RATE and tcfg.N_MELS == jcfg.N_MELS


def test_port_tokenizer_matches_the_jax_package(tmp_path):
    from whisper_tpu.text import tokenizer as jtok
    from whisper_tpu_torch.text import tokenizer as ttok

    ttok.build_test_tokenizer_json(str(tmp_path / "t.json"))
    jtok.build_test_tokenizer_json(str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    t = ttok.WhisperTokenizer(str(tmp_path / "t.json"))
    j = jtok.WhisperTokenizer(str(tmp_path / "j.json"))
    text = " hello world, 123 and more text"
    assert t.encode(text) == j.encode(text)
    assert t.vocab_size == j.vocab_size and t.eot == j.eot
    for lang in ("en", "de"):
        assert t.prompt_ids(lang) == j.prompt_ids(lang)
        assert (t.prompt_ids(lang, timestamps=True)
                == j.prompt_ids(lang, timestamps=True))
    np.testing.assert_array_equal(t.suppress_mask(), j.suppress_mask())
    ids = list(range(0, t.vocab_size, 7))
    assert t.decode(ids) == j.decode(ids)
    assert ttok.LANGUAGES_V3 == jtok.LANGUAGES_V3
