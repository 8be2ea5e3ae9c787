"""The port's mesh (`whisper_tpu_torch/parallel/`) against the JAX package's
on the CPU.

In-process: `param_specs` leaf for leaf against JAX's `param_pspecs`, the
errors of `validate_tp` and `make_mesh`, `dp_axis`/`tp_axis`, shard ->
gather round trips, the refusals (a quantized tree, `draft=` with
`mesh=`), the fused-MLP gate under meshes, and a `single_device_mesh()`
Transcriber against the meshless port.

Ranks: two spawns of SPMD ranks through `parallel/launch.spawn` (gloo on
the CPU, a `file://` rendezvous in a temporary directory, one thread a
rank): two ranks run a tp=2 mesh, then a dp=2 mesh; four ranks a dp=2 x
tp=2 mesh. Over each mesh, each rank (`tests/torch_parallel_rank.
py`, torch only) runs greedy and beam 3 over one stream, then through
`BatchTranscriber.transcribe_many` over two streams greedy, beam 3 with
int8 self and cross caches over streams of different loudness, and a
sampling rung; the cache scales of a quantized prefill over windows of
different loudness; two train steps with a save, a restore, and a save of
the fresh state. The parent holds them against JAX's MESHLESS outputs,
computed once per module on one device (JAX's own tests pin meshed JAX to
meshless JAX), and the sampling rung and the scales against the meshless
port. The weights come from the port's initializer as numpy, with random
biases (the initializers make them zero), so a row-parallel bias added on
every tp rank shows.

Tolerances. Tokens are EQUAL (f32; the port's kernels run their plain
versions on CPU tensors at the local head count, JAX attention="xla").
Scales: the cross cache's (layer, channel) scales and the self cache's
row scales within SCALE_RTOL of the meshless port's (f32 products over
the same values, the local half of a GEMM's columns). Train metrics
(loss, accuracy, tokens, grad_norm) within LOSS_RTOL of JAX's, and each
leaf after two steps within PARAM_RTOL by relative L2, the key-bias
columns bounded apart (tests/test_torch_training.py says why), as in
that file.
"""

import logging
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.config import tiny_test_config as jax_tiny_config
from whisper_tpu.parallel import context as jctx
from whisper_tpu.parallel import mesh as jmesh
from whisper_tpu.parallel import sharding as jsharding
from whisper_tpu.pipeline import batch as JB
from whisper_tpu.pipeline import transcribe as JT
from whisper_tpu.text.tokenizer import WhisperTokenizer as JaxTokenizer
from whisper_tpu.training import train as JTR
from whisper_tpu_torch.config import tiny_test_config
from whisper_tpu_torch.models import whisper as TM
from whisper_tpu_torch.ops.audio import max_waveform_samples
from whisper_tpu_torch.parallel import context as tctx
from whisper_tpu_torch.parallel import launch, mesh as tmesh
from whisper_tpu_torch.parallel import sharding as tsharding
from whisper_tpu_torch.params import from_numpy_tree, init_params, numpy_tree
from whisper_tpu_torch.pipeline import transcribe as TT
from whisper_tpu_torch.quantize import quantize_params
from whisper_tpu_torch.text.tokenizer import (WhisperTokenizer,
                                              build_test_tokenizer_json)

import torch_parallel_rank as rank_side
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

SCALE_RTOL = 1e-6
LOSS_RTOL = 1e-6
PARAM_RTOL = 1e-4
JOIN_TIMEOUT_S = 120.0

ENC_CTX = 96
MAX_DEPTH = 6
LR = 1e-3
OPT = dict(learning_rate=LR, weight_decay=0.01, warmup_steps=1,
           total_steps=10)
MESHES = {"tp2": (1, 2), "dp2": (2, 1), "dp2tp2": (2, 2)}
# the spawns: two ranks run the tp=2 and the dp=2 mesh one after the
# other, four ranks the dp=2 x tp=2 mesh
SPAWNS = {2: ("tp2", "dp2"), 4: ("dp2tp2",)}
# the key bias's gradient is rounding noise (tests/test_torch_training.py)
K_BIAS = {"decoder.blocks.qkv_b": 1, "encoder.blocks.qkv_b": 1,
          "decoder.blocks.cross_kv_b": 0}


def _dims(vocab):
    return dict(n_state=64, n_head=4, n_layer=2, n_vocab=vocab,
                n_audio_ctx=ENC_CTX, n_text_ctx=48)


def _opts(**kw):
    # windows with no overlap: every window full, one program shape in JAX
    return dict(max_depth=MAX_DEPTH, chunk_overlap_seconds=0.0, **kw)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return make_case(tmp_path_factory.mktemp("torch_parallel"))


def make_case(d):
    """The case every rank and both references run: JAX's tiny params with
    random biases (numpy), the test tokenizer, one stream of two windows,
    two streams of different loudness, the options, a training batch."""
    tok_path = str(d / "tokenizer.json")
    build_test_tokenizer_json(tok_path)
    tok = WhisperTokenizer(tok_path)
    dims = _dims(tok.vocab_size)
    params = numpy_tree(init_params(tiny_test_config(**dims),
                                    torch.Generator().manual_seed(5)))
    rng = np.random.default_rng(11)
    # weights x10 and embeddings x0.1, so that the tokens follow the audio
    # and every layer (at init scale the embeddings decide them alone)
    for part in ("encoder", "decoder"):
        blocks = params[part]["blocks"]
        for k in blocks:
            if k.endswith("_b"):
                blocks[k] = (0.1 * rng.standard_normal(blocks[k].shape)
                             ).astype(np.float32)
            elif k.endswith("_w"):
                blocks[k] = blocks[k] * np.float32(10.0)
    for k in ("tok_emb", "pos_emb"):
        params["decoder"][k] = params["decoder"][k] * np.float32(0.1)
    n = max_waveform_samples(ENC_CTX - 10)
    t = np.arange(2 * n) / 16000.0
    wave = (0.3 * np.sin(2 * np.pi * 220.0 * t)
            + 0.1 * rng.standard_normal(2 * n)).astype(np.float32)
    waves = [wave, (0.05 * rng.standard_normal(2 * n)).astype(np.float32)]
    mel = rng.standard_normal((4, 80, 32)).astype(np.float32)
    tokens = rng.integers(0, 300, size=(4, 12)).astype(np.int32)
    mask = np.ones((4, 12), np.float32)
    mask[:, :3] = 0.0
    mask[1, 8:] = 0.0
    case = dict(
        dims=dims, params=params, tok=tok_path, wave=wave, waves=waves,
        batch_size=4,
        single={"greedy": _opts(strategy="greedy"),
                "beam": _opts(beam_size=3)},
        many={"greedy": _opts(strategy="greedy"),
              "quant_beam": _opts(beam_size=3, kv_quant="int8",
                                  self_quant="int8"),
              "sampled": _opts(strategy="greedy", temperature=(0.8,),
                               compression_ratio_threshold=None,
                               logprob_threshold=None)},
        enc=np.stack([s * rng.standard_normal((ENC_CTX // 2, 64))
                      for s in (0.5, 1.0, 2.0, 4.0)]).astype(np.float32),
        prompt=np.asarray(tok.prompt_ids("en"), np.int64),
        batch=(mel, tokens, mask), opt=OPT, steps=2, remat=True,
        save_dir=str(d))
    return case


@pytest.fixture(scope="module")
def jax_refs(setup):
    """JAX's meshless outputs, on one device, once for the module."""
    case = setup
    jcfg = jax_tiny_config(**case["dims"])
    jtok = JaxTokenizer(case["tok"])
    out = {}
    tr = JT.Transcriber(case["params"], jcfg, jtok, attention="xla",
                        matmul_precision="highest")
    for name, kw in case["single"].items():
        out[f"single_{name}"] = tr.transcribe(case["wave"], 16000,
                                              JT.DecodeOptions(**kw))[1]
    bt = JB.BatchTranscriber(case["params"], jcfg, jtok, attention="xla",
                             matmul_precision="highest", batch_size=4)
    for name in ("greedy", "quant_beam"):
        res = bt.transcribe_many(case["waves"], 16000,
                                 JT.DecodeOptions(**case["many"][name]))
        out[f"many_{name}"] = [toks for _, toks in res]
    opt = JTR.make_optimizer(**OPT)
    state = JTR.init_train_state(jax.tree.map(jnp.asarray, case["params"]),
                                 opt)
    step = JTR.make_train_step(jcfg, opt)
    batch = JTR.Batch(*(jnp.asarray(x) for x in case["batch"]))
    metrics = []
    for _ in range(case["steps"]):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    out["train"] = {"metrics": metrics,
                    "params": jax.tree.map(np.asarray, state.params)}
    return out


@pytest.fixture(scope="module")
def meshless(setup):
    """The meshless port on the same case, in this process."""
    case = dict(setup, save_dir=setup["save_dir"])
    return {"decode": rank_side.decode_all(case),
            "scales": rank_side.scale_checks(case),
            "train": rank_side.train_and_save(case)}


@pytest.fixture(scope="module")
def spawns(setup, tmp_path_factory):
    """Every rank's outputs of each spawn, by mesh name."""
    runs = {}

    def run(world):
        d = tmp_path_factory.mktemp(f"ranks_{world}")
        meshes = {name: MESHES[name] for name in SPAWNS[world]}
        case = dict(setup, meshes=meshes, save_dir=str(d))
        outs = launch.spawn(rank_side.run_case, world, (case,),
                            init_method=launch.file_init_method(str(d)),
                            backend="gloo", timeout_s=JOIN_TIMEOUT_S,
                            threads=1)
        for name in meshes:
            runs[name] = {"outs": [o[name] for o in outs],
                          "dir": d / name}

    return run, runs


@pytest.fixture(params=list(MESHES))
def ranks(request, spawns):
    """Every rank's outputs over the mesh of the param (its spawn runs at
    the first test that asks for one of its meshes)."""
    run, runs = spawns
    world = next(w for w, names in SPAWNS.items() if request.param in names)
    if request.param not in runs:
        run(world)
    dp, tp = MESHES[request.param]
    return dict(runs[request.param], name=request.param, dp=dp, tp=tp)


def _flat(tree, prefix="", leaf=np.asarray):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}.", leaf))
        else:
            out[f"{prefix}{k}"] = leaf(v)
    return out


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30))


# ------------------------------------------------------------ in-process


def _as_tuples(tree):
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    return tuple(tree)


def test_param_specs_match_jax(setup):
    kw = setup["dims"]
    want = _as_tuples(jsharding.param_pspecs(jax_tiny_config(**kw)))
    assert tsharding.param_specs(tiny_test_config(**kw)) == want


@pytest.mark.parametrize("heads,state,tp", [
    (4, 64, 3), (6, 384, 4), (4, 64, 2), (20, 1280, 5), (2, 6, 4)])
def test_validate_tp_matches_jax(heads, state, tp):
    kw = dict(n_state=state, n_head=heads)

    def outcome(fn, cfg):
        try:
            fn(cfg, tp)
            return None
        except ValueError as e:
            return str(e)

    assert (outcome(tsharding.validate_tp, tiny_test_config(**kw))
            == outcome(jsharding.validate_tp, jax_tiny_config(**kw)))


@pytest.mark.parametrize("dp,tp", [(None, 2), (None, 3), (1, 2), (2, 1),
                                   (None, 1)])
def test_make_mesh_matches_jax_on_one_device(dp, tp):
    """One process (no process group) is a world of one device, as JAX's
    make_mesh over one device: the same errors, else a (1, 1) mesh."""

    def outcome(make):
        try:
            return dict(make().shape)
        except ValueError as e:
            return str(e)

    want = outcome(lambda: jmesh.make_mesh(dp=dp, tp=tp,
                                           devices=jax.devices()[:1]))
    assert outcome(lambda: tmesh.make_mesh(dp=dp, tp=tp)) == want
    if isinstance(want, dict):
        assert want == {"dp": 1, "tp": 1}


@pytest.mark.parametrize("dp,tp", [(1, 1), (2, 1), (1, 2), (2, 2), (4, 2),
                                   (1, 4), (3, 5)])
def test_dp_tp_axis_match_jax(dp, tp):
    stub = types.SimpleNamespace(shape={"dp": dp, "tp": tp})
    for sizes in ((1,), (2,), (4, 8), (6,), (3, 6)):
        assert tctx.dp_axis(stub, *sizes) == jctx.dp_axis(stub, *sizes)
    for heads, chans in ((4, (64,)), (6, (384, 1536)), (20, (1280,)),
                         (5, (320,)), (2, (6,))):
        assert (tctx.tp_axis(stub, heads, *chans)
                == jctx.tp_axis(stub, heads, *chans))
    assert tctx.tp_size(stub) == jctx.tp_size(stub) == tp


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_gather_round_trip(setup, tp):
    """Every tp rank's shards are contiguous copies of the right slices,
    and concatenated in rank order they give the tree back exactly."""
    cfg = tiny_test_config(**setup["dims"])
    full = from_numpy_tree(setup["params"])
    specs = _flat(tsharding.param_specs(cfg), leaf=tuple)
    shards = [tsharding.shard_params(full, tmesh.Mesh(1, tp, r), cfg)
              for r in range(tp)]
    want = {k: v for k, v in _flat(full.tree()).items()}
    for name, w in want.items():
        parts = [_flat(s.tree())[name] for s in shards]
        spec = specs[name]
        if "tp" not in spec:
            assert all(np.array_equal(p, w) for p in parts), name
            continue
        dim = spec.index("tp")
        assert all(p.shape[dim] * tp == w.shape[dim] for p in parts), name
        np.testing.assert_array_equal(np.concatenate(parts, axis=dim), w)
    leaf = shards[1]["decoder"]["blocks"]["qkv_w"]
    assert leaf.is_contiguous() and leaf.shape[-1] == cfg.n_state // tp
    # a shard is a copy, never a view of the full tensor
    assert (leaf.untyped_storage().data_ptr() != full["decoder"]["blocks"][
        "qkv_w"].untyped_storage().data_ptr())
    # gather on a one-rank mesh is the identity
    back = tsharding.gather_params(full, tmesh.single_device_mesh(), cfg)
    for name, w in _flat(back.tree()).items():
        np.testing.assert_array_equal(w, want[name])


def test_refusals(setup):
    """A quantized tree cannot be sharded (JAX's shard_params fails on
    QTensor leaves too), and draft= with mesh= raises JAX's message."""
    cfg = tiny_test_config(**setup["dims"])
    tok = WhisperTokenizer(setup["tok"])
    q = quantize_params(from_numpy_tree(setup["params"]))
    with pytest.raises(ValueError, match="quantized"):
        tsharding.shard_params(q, tmesh.Mesh(1, 2, 0), cfg)
    with pytest.raises(ValueError, match="quantized"):
        TT.Transcriber(q, cfg, tok, device="cpu",
                       mesh=tmesh.single_device_mesh())
    with pytest.raises(ValueError, match="draft= does not compose with "
                       "mesh="):
        TT.Transcriber(setup["params"], cfg, tok, device="cpu",
                       mesh=tmesh.single_device_mesh(),
                       draft=(setup["params"], cfg))


def test_fused_mlp_gate_follows_the_mesh():
    """K2 runs without a mesh and under dp-only meshes, never under tp > 1
    (JAX's gate, whisper.py:347-351). Only `x.is_cuda` is read from x."""
    x = types.SimpleNamespace(is_cuda=True)
    w1 = torch.zeros(4, 8)
    assert TM._use_fused_mlp(x, w1, "flash")
    for dp, tp, on in ((2, 1, True), (4, 1, True), (1, 2, False),
                       (2, 2, False)):
        with tctx.kernel_mesh(tmesh.Mesh(dp, tp, 0)):
            assert TM._use_fused_mlp(x, w1, "flash") == on, (dp, tp)
    assert not TM._use_fused_mlp(types.SimpleNamespace(is_cuda=False), w1,
                                 "flash")


@pytest.mark.parametrize("dp,size,want", [(2, 3, 4), (2, 4, 4), (4, 6, 8),
                                           (1, 3, 3)])
def test_batch_size_rounds_up_to_dp(setup, caplog, dp, size, want):
    """BatchTranscriber(mesh=) rounds batch_size up to a multiple of dp,
    with JAX's log line (a mesh position of this process alone: building
    the transcriber runs no collective)."""
    from whisper_tpu_torch.pipeline.batch import BatchTranscriber

    cfg = tiny_test_config(**setup["dims"])
    tok = WhisperTokenizer(setup["tok"])
    # the package logger hands its records to caplog directly: a CLI test
    # earlier in this worker may have turned its propagation off
    logger = logging.getLogger("whisper_tpu_torch")
    logger.addHandler(caplog.handler)
    try:
        with caplog.at_level("INFO", logger="whisper_tpu_torch"):
            bt = BatchTranscriber(setup["params"], cfg, tok, device="cpu",
                                  batch_size=size,
                                  mesh=tmesh.Mesh(dp, 1, 0))
    finally:
        logger.removeHandler(caplog.handler)
    assert bt.batch_size == want
    line = f"batch_size {size} rounded up to {want} (multiple of dp={dp})"
    assert (line in caplog.text) == (size != want)


def test_single_device_mesh_transcriber_matches_meshless(setup, meshless):
    """The meshed code path on one process with no process group: the
    same tokens as the meshless port, greedy and beam."""
    case = dict(setup, single=setup["single"], many={})
    got = rank_side.decode_all(case, tmesh.single_device_mesh())
    for name in setup["single"]:
        name = f"single_{name}"
        assert got[name] == meshless["decode"][name], name


# ------------------------------------------------------------ ranks


def test_failed_rank_stops_the_run(tmp_path):
    """A rank that raises fails the spawn with its traceback, and its
    hanging peer is stopped rather than waited for."""
    t0 = time.monotonic()
    with pytest.raises(torch.multiprocessing.ProcessRaisedException,
                       match="fails on purpose"):
        launch.spawn(rank_side.fail_or_hang, 2,
                     init_method=launch.file_init_method(str(tmp_path)),
                     backend="gloo", timeout_s=JOIN_TIMEOUT_S, threads=1)
    assert time.monotonic() - t0 < JOIN_TIMEOUT_S / 4


def test_ranks_hold_their_positions(ranks):
    """Each rank sits at (rank // tp, rank % tp), ran one thread and never
    imported JAX."""
    for r, out in enumerate(ranks["outs"]):
        assert out["rank"] == r
        assert (out["dp_rank"], out["tp_rank"]) == divmod(r, ranks["tp"])
        assert out["threads"] == 1 and not out["jax_imported"]


def test_meshed_decodes_match_jax(ranks, jax_refs):
    """Greedy and beam 3 over one stream, and transcribe_many greedy and
    quantized-cache beam over two streams: every rank's tokens equal JAX's
    meshless tokens."""
    for out in ranks["outs"]:
        dec = out["decode"]
        for name in ("single_greedy", "single_beam", "many_greedy",
                     "many_quant_beam"):
            assert dec[name] == jax_refs[name], (ranks["name"], name)


def test_meshed_sampling_rung_matches_meshless_port(ranks, meshless):
    """A sampling rung (temperature 0.8) through transcribe_many: each dp
    rank draws the meshless batch's noise for its rows."""
    want = meshless["decode"]["many_sampled"]
    assert any(len(t) > 4 for t in want)
    for out in ranks["outs"]:
        assert out["decode"]["many_sampled"] == want, ranks["name"]


def test_meshed_cache_scales_match_meshless(ranks, meshless):
    """The cross cache's channel scales over windows of different loudness
    (a dp MAX when the windows are split over dp) and the self cache's row
    scales (a tp MAX when the channels are split over tp) equal the
    meshless port's. Without either MAX a rank's scales come from its
    own part and differ by the loudness ratios."""
    want = meshless["scales"]
    for out in ranks["outs"]:
        got = out["scales"]
        n = got["self_k_rows"].shape[0]
        rows = slice(got["first"], got["first"] + n)
        c = got["cross_k_scale"].shape[1]  # this rank's channels
        chans = slice(out["tp_rank"] * c, (out["tp_rank"] + 1) * c)
        for key in ("cross_k_scale", "cross_v_scale"):
            np.testing.assert_allclose(got[key], want[key][:, chans],
                                       rtol=SCALE_RTOL,
                                       err_msg=f"{ranks['name']} {key}")
        for key in ("self_k_rows", "self_v_rows"):
            np.testing.assert_allclose(got[key], want[key][rows],
                                       rtol=SCALE_RTOL,
                                       err_msg=f"{ranks['name']} {key}")


def test_meshed_train_steps_match_jax(ranks, jax_refs):
    """Two steps (remat on) over the mesh: each step's metrics and the
    gathered params after them against JAX's meshless steps."""
    want = jax_refs["train"]
    wparams = _flat(want["params"])
    for out in ranks["outs"]:
        tr = out["train"]
        for got_m, want_m in zip(tr["metrics"], want["metrics"]):
            for key in ("loss", "accuracy", "tokens", "grad_norm"):
                np.testing.assert_allclose(
                    got_m[key], want_m[key], rtol=LOSS_RTOL,
                    err_msg=f"{ranks['name']} {key}")
        got = _flat(tr["params"])
        assert set(got) == set(wparams)
        for name, w in wparams.items():
            g = got[name]
            if name in K_BIAS:
                col = K_BIAS[name]
                assert np.abs(g[:, col] - w[:, col]).max() <= 3 * LR * (
                    1 + 1e-3), name
                g, w = np.delete(g, col, axis=1), np.delete(w, col, axis=1)
            assert _rel(g, w) <= PARAM_RTOL, (ranks["name"], name)


def test_meshed_save_is_the_meshless_file(ranks, meshless, setup):
    """A save of the fresh state over the mesh (gathered, written by rank
    0) has the meshless save's bytes; the save after two steps restores
    into a fresh sharded state exactly, with its step."""
    import os

    meshed = os.path.join(ranks["dir"], "fresh.pt")
    plain = os.path.join(setup["save_dir"], "fresh.pt")
    with open(meshed, "rb") as f, open(plain, "rb") as g:
        assert f.read() == g.read()
    for out in ranks["outs"]:
        assert out["train"]["restored"] and out["train"]["step"] == 2
