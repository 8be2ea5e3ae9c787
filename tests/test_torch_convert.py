"""The port's checkpoint writers, `convert` / `convert-pt` and the host
beam search vs the JAX package's, on the CPU.

The writers must give the JAX package's bytes: `cli.py convert` writes the
`.cfg` file of the JAX CLI byte for byte, the same Burn record once
gunzipped (gzip writes the time into its header), and the `.safetensors`
file that the JAX writer (`checkpoint.save_safetensors`) gives for the
same tree with C-contiguous leaves; every file loads bit-equal in both
packages' loaders, to the tree it was written from. (The JAX CLI hands
the writer transposed views -- a dump tree's conv weights, `convert-pt`'s
linears -- and safetensors 0.4 on writes a view's buffer as it lies in
memory, so the JAX CLI's own `.safetensors` holds those tensors out of
order; the port writes contiguous copies: `io/checkpoint.py::
flatten_params`.) `convert-pt` gives the same files on synthetic OpenAI
and HuggingFace state dicts (built as tests/test_convert_pt.py builds
them, from a tiny JAX parameter tree).
`host_beam.beam_search` returns the same beams as JAX's under the same
callbacks, ties included.
"""

import gzip
import json
import os
import random

import jax
import numpy as np
import pytest
import torch

from test_convert_pt import CFG, _dims, _hf_sd, _openai_sd
from whisper_tpu import cli as jax_cli
from whisper_tpu.decode import host_beam as JH
from whisper_tpu.io import checkpoint as JC
from whisper_tpu.io import convert_pt as JP
from whisper_tpu.io import npy_tree as JN
from whisper_tpu.models import whisper as JM
from whisper_tpu_torch import cli as torch_cli
from whisper_tpu_torch.decode import host_beam as TH
from whisper_tpu_torch.io import checkpoint as TC
from whisper_tpu_torch.io import convert_pt as TP
from whisper_tpu_torch.io import npy_tree as TN


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A tiny JAX parameter tree (numpy leaves) and its npy dump tree."""
    d = tmp_path_factory.mktemp("torch_convert")
    params = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(9),
                                                     CFG))
    JN.save_whisper(params, CFG, str(d / "dump"))
    return params, d


def _assert_tree_equal(got, want):
    fg, fw = TC.flatten_params(got), JC.flatten_params(want)
    assert sorted(fg) == sorted(fw)
    for k in fw:
        assert fg[k].dtype == fw[k].dtype, k
        np.testing.assert_array_equal(fg[k], fw[k], err_msg=k)


def _files(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            path = os.path.join(dirpath, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _jax_safetensors(tree, cfg, path):
    """The bytes of the JAX package's safetensors writer over the tree with
    C-contiguous leaves."""
    JC.save_safetensors(jax.tree.map(np.ascontiguousarray, tree), cfg,
                        str(path))
    return path.read_bytes()


def _both_clis(capsys, argv_jax, argv_torch):
    """Run the JAX CLI and the port's; (rc, stdout, stderr) of each."""
    out = []
    for main, argv in ((jax_cli.main, argv_jax), (torch_cli.main, argv_torch)):
        rc = main(argv)
        o, e = capsys.readouterr()
        out.append((rc, o, e))
    return out


@pytest.mark.parametrize("mpk", [False, True])
def test_convert_writes_the_jax_clis_files(setup, monkeypatch, capsys, mpk):
    """`convert dump --out NAME [--mpk]`: the same progress lines, the JAX
    CLI's .cfg bytes, the JAX writer's .safetensors bytes, the JAX CLI's
    .mpk.gz after gunzip; each file loads bit-equal to the tree in both
    packages' loaders."""
    params, d = setup
    monkeypatch.chdir(d)
    extra = ["--mpk"] if mpk else []
    (jrc, jout, _), (trc, tout, _) = _both_clis(
        capsys, ["convert", "dump", "--out", "jax_m", *extra],
        ["convert", "dump", "--out", "torch_m", *extra])
    assert jrc == trc == 0
    assert tout == jout == "Saving model...\nSaving config...\nFinished.\n"
    assert (d / "torch_m.cfg").read_bytes() == (d / "jax_m.cfg").read_bytes()
    assert (d / "torch_m.safetensors").read_bytes() == _jax_safetensors(
        *JN.load_whisper("dump"), d / "want.safetensors")
    assert os.path.exists("torch_m.mpk.gz") == mpk
    names = ["torch_m.safetensors"]
    if mpk:
        assert (gzip.decompress((d / "torch_m.mpk.gz").read_bytes())
                == gzip.decompress((d / "jax_m.mpk.gz").read_bytes()))
        names.append("torch_m.mpk.gz")
    for name in names:
        for load in (TC.load_params, JC.load_params):
            got, cfg = load(name)
            _assert_tree_equal(got, params)
            assert cfg.to_cfg_dict() == CFG.to_cfg_dict()


def test_convert_error_exit_matches_jax(setup, monkeypatch, capsys):
    _, d = setup
    monkeypatch.chdir(d)
    (jrc, jout, jerr), (trc, tout, terr) = _both_clis(
        capsys, ["convert", "missing"], ["convert", "missing"])
    assert jrc == trc == 1 and tout == jout == ""
    assert "Error loading model missing" in terr
    assert terr.split(":")[0] == jerr.split(":")[0]


def test_save_whisper_round_trips_through_both_loaders(setup, tmp_path):
    """The port's npy dump tree is the JAX writer's, file for file and byte
    for byte, and loads back to the same tree and config in both."""
    params, _ = setup
    TN.save_whisper(params, CFG, str(tmp_path / "torch"))
    JN.save_whisper(params, CFG, str(tmp_path / "jax"))
    got = _files(tmp_path / "torch")
    assert got == _files(tmp_path / "jax") and len(got) > 50
    for load in (TN.load_whisper, JN.load_whisper):
        tree, cfg = load(str(tmp_path / "torch"))
        _assert_tree_equal(tree, params)
        assert cfg.to_cfg_dict() == CFG.to_cfg_dict()


# ---------------------------------------------------------------- convert-pt


def _write_pt(kind, params, d):
    """A synthetic checkpoint file of one kind; returns its path."""
    path = str(d / f"{kind}.pt")
    sd = _openai_sd(params)
    if kind == "openai":
        obj = {"dims": _dims(), "model_state_dict": sd}
    elif kind == "bare":
        obj = sd
    elif kind == "fp16":
        obj = {"dims": _dims(),
               "model_state_dict": {k: v.half() for k, v in sd.items()}}
    elif kind == "embedded_heads":
        obj = {"dims": _dims(), "model_state_dict": sd,
               "alignment_heads": torch.tensor([[False, True], [True, False]])}
    elif kind == "hf":
        path = str(d / "hf" / "pytorch_model.bin")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        obj = _hf_sd(params)
        with open(d / "hf" / "generation_config.json", "w") as f:
            # HF heads are d // 64: one head at d = 8
            json.dump({"alignment_heads": [[1, 0], [0, 0]]}, f)
    elif kind == "hf_wrapped":
        obj = {"state_dict": _hf_sd(params)}
    else:
        obj = {"foo": torch.zeros(3)}
    torch.save(obj, path)
    return path


@pytest.mark.parametrize("kind", ["openai", "bare", "fp16", "embedded_heads",
                                  "hf", "hf_wrapped", "junk"])
def test_load_pt_matches_jax(setup, tmp_path, kind):
    """`convert_pt.load_pt` on OpenAI (with dims, bare, fp16, a mask in the
    file) and HF (with a sibling generation_config.json, or under a
    "state_dict" key) checkpoints: the JAX tree and config; an
    unrecognized file raises ValueError in both."""
    params, _ = setup
    path = _write_pt(kind, params, tmp_path)
    if kind == "junk":
        for mod in (TP, JP):
            with pytest.raises(ValueError, match="unrecognized"):
                mod.load_pt(path)
        return
    got, gcfg = TP.load_pt(path)
    want, wcfg = JP.load_pt(path)
    _assert_tree_equal(got, want)
    assert gcfg.to_cfg_dict() == wcfg.to_cfg_dict()
    assert gcfg.alignment_heads == wcfg.alignment_heads
    if kind in ("hf", "embedded_heads"):
        assert gcfg.alignment_heads


@pytest.mark.parametrize("heads", [
    [[1, 0], [0, 1]], np.array([[True, False], [False, True]]),
    torch.tensor([[0, 1]]), torch.tensor([[1, 0], [0, 1]]).to_sparse()])
def test_alignment_head_forms_match_jax(heads):
    """Pairs, an (L, H) boolean mask, an integer pair tensor and a sparse
    mask normalize and validate alike; an out-of-range head raises."""
    assert TP._normalize_heads(heads) == JP._normalize_heads(heads)
    assert TP._validated_heads(heads, CFG) == JP._validated_heads(heads, CFG)
    for mod in (TP, JP):
        with pytest.raises(ValueError, match="out of range"):
            mod._validated_heads([[CFG.text_decoder_config.n_text_layer, 0]],
                                 CFG)


CONVERT_PT_CASES = {
    "openai_dump_tree": ("openai", ["--dump-tree"], 0),
    "openai_heads_json": ("openai", ["--alignment-heads", "[[1, 0]]"], 0),
    "openai_heads_file": ("openai", ["--alignment-heads", "heads.json"], 0),
    "hf_sibling_heads": ("hf", ["--dump-tree"], 0),
    "bad_heads_json": ("openai", ["--alignment-heads", "[[1, 0"], 1),
    "heads_file_without_key": ("openai", ["--alignment-heads", "gen.json"], 1),
    "junk": ("junk", [], 1),
}


@pytest.mark.parametrize("case", sorted(CONVERT_PT_CASES))
def test_convert_pt_writes_the_jax_clis_files(setup, monkeypatch, capsys,
                                              tmp_path, case):
    """`convert-pt <pt> <out> [--dump-tree] [--alignment-heads JSON|PATH]`
    through both CLIs: the same exit code and printed lines, the JAX CLI's
    .cfg bytes and dump tree, and the JAX writer's .safetensors bytes over
    the tree `load_pt` gives (a file that loads back to it)."""
    params, _ = setup
    kind, flags, code = CONVERT_PT_CASES[case]
    monkeypatch.chdir(tmp_path)
    path = _write_pt(kind, params, tmp_path)
    (tmp_path / "heads.json").write_text(
        json.dumps({"alignment_heads": [[0, 1], [1, 1]]}))
    (tmp_path / "gen.json").write_text(json.dumps({"max_length": 448}))
    (jrc, jout, jerr), (trc, tout, terr) = _both_clis(
        capsys, ["convert-pt", path, "jax_o", *flags],
        ["convert-pt", path, "torch_o", *flags])
    assert jrc == trc == code
    assert tout == jout
    if code:
        assert terr.split(":")[0] == jerr.split(":")[0] and terr
        assert not os.path.exists("torch_o.safetensors")
        return
    assert "Finished." in tout
    assert (tmp_path / "torch_o.cfg").read_bytes() == (
        tmp_path / "jax_o.cfg").read_bytes()
    tree = JP.load_pt(path)[0]
    cfg = JC.WhisperConfig.load("jax_o.cfg")
    assert (tmp_path / "torch_o.safetensors").read_bytes() == (
        _jax_safetensors(tree, cfg, tmp_path / "want.safetensors"))
    _assert_tree_equal(TC.load_params("torch_o.safetensors")[0], tree)
    if "--dump-tree" in flags:
        got = _files(tmp_path / "torch_o")
        assert got == _files(tmp_path / "jax_o") and got
    if "heads" in case:
        assert "alignment_heads" in json.loads(
            (tmp_path / "torch_o.cfg").read_text())


# ---------------------------------------------------------------- host beam


def _callbacks(seed, vocab, eot, ties):
    """`next` and `is_finished` over a seeded table of log-probs: each
    prefix's continuations are drawn once and remembered, from few
    distinct values when `ties`."""
    table = {}

    def next_fn(beams):
        out = []
        for b in beams:
            key = tuple(b.seq)
            if key not in table:
                r = random.Random(hash((seed,) + key))
                if ties:
                    vals = [-float(r.randint(0, 3)) for _ in range(vocab)]
                else:
                    vals = [-r.random() * 4 for _ in range(vocab)]
                table[key] = [(t, b.log_prob + v)
                              for t, v in zip(range(vocab), vals)]
            out.append(table[key])
        return out

    return next_fn, lambda seq: bool(seq) and seq[-1] == eot


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("beam_size,seed", [(1, 0), (3, 1), (5, 2)])
def test_host_beam_search_matches_jax(beam_size, seed, ties):
    """The same beams, in the same order, step by step, and the same best
    sequence, with distinct scores and with many ties."""
    vocab, eot = 7, 6
    nxt_j, fin_j = _callbacks(seed, vocab, eot, ties)
    nxt_t, fin_t = _callbacks(seed, vocab, eot, ties)
    jbeams = [JH.BeamNode([0], 0.0)]
    tbeams = [TH.BeamNode([0], 0.0)]
    for _ in range(6):
        jbeams = JH.beam_search_step(jbeams, nxt_j, fin_j, beam_size)
        tbeams = TH.beam_search_step(tbeams, nxt_t, fin_t, beam_size)
        assert ([(b.seq, b.log_prob) for b in tbeams]
                == [(b.seq, b.log_prob) for b in jbeams])
    want = JH.beam_search([JH.BeamNode([0], 0.0)], nxt_j, fin_j, beam_size, 8)
    got = TH.beam_search([TH.BeamNode([0], 0.0)], nxt_t, fin_t, beam_size, 8)
    assert got == want and got[0] == 0
    assert TH.beam_search([], nxt_t, fin_t, beam_size, 3) == []
    elems = [random.Random(seed + i).randint(0, 3) for i in range(20)]
    assert (TH._top_elements(elems, float, beam_size)
            == JH._top_elements(elems, float, beam_size))
