"""The port's trainer (`whisper_tpu_torch/training/`) against the JAX
package's on the CPU: the loss and its metrics, the gradients over two
consecutive steps, remat, optax's schedule and clip, params after three
AdamW steps, the data pipeline, SpecAugment's masking, the refusals, and
the debug and profiling helpers.

Weights come from JAX's `init_params` through `from_numpy_tree` /
`trainable`, inputs from a numpy seed; both packages get the same arrays.
"""

import functools
import json
import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from whisper_tpu.config import tiny_test_config as jax_tiny_config
from whisper_tpu.models import whisper as JM
from whisper_tpu.text.tokenizer import WhisperTokenizer as JaxTokenizer
from whisper_tpu.training import data as JD
from whisper_tpu.training import train as JT
from whisper_tpu_torch.config import tiny_test_config
from whisper_tpu_torch.params import from_numpy_tree, numpy_tree, trainable
from whisper_tpu_torch.quantize import quantize_params
from whisper_tpu_torch.text.tokenizer import (WhisperTokenizer,
                                              build_test_tokenizer_json)
from whisper_tpu_torch.training import data as TD
from whisper_tpu_torch.training import train as TT
from whisper_tpu_torch.utils import debug, profiling

# loss, accuracy and token count: f32 sums of the same terms in another
# order
LOSS_RTOL = 1e-6
# each leaf's gradient, relative L2: f32 forward and backward in another
# order of sums
GRAD_RTOL = 1e-5
# each leaf after 3 AdamW steps, relative L2
PARAM_RTOL = 1e-4
# optax's schedule (f32) against the port's (f32 scalars in numpy)
SCHEDULE_RTOL = 1e-6
# one clipped AdamW update against optax's on the same gradients
UPDATE_RTOL = 1e-6
# log-mel of the same waveforms (tests/test_torch_audio.py's tolerance)
MEL_ATOL = 1e-4

LR, WD, WARMUP, TOTAL = 1e-3, 0.01, 1, 10


@pytest.fixture(scope="module")
def tok(tmp_path_factory):
    d = tmp_path_factory.mktemp("tok")
    build_test_tokenizer_json(str(d / "tokenizer.json"))
    return WhisperTokenizer(str(d / "tokenizer.json"))


@pytest.fixture(scope="module")
def jtok(tok, tmp_path_factory):
    d = tmp_path_factory.mktemp("jtok")
    build_test_tokenizer_json(str(d / "tokenizer.json"))
    return JaxTokenizer(str(d / "tokenizer.json"))


@pytest.fixture(scope="module")
def cfgs(tok):
    kw = dict(n_state=32, n_head=2, n_layer=2, n_vocab=tok.vocab_size,
              n_audio_ctx=32, n_text_ctx=24)
    return jax_tiny_config(**kw), tiny_test_config(**kw)


@pytest.fixture(scope="module")
def start(cfgs):
    """JAX's initial params as numpy."""
    return jax.tree.map(np.asarray,
                        JM.init_params(jax.random.PRNGKey(0), cfgs[0]))


@pytest.fixture(scope="module")
def batch_np(tok, cfgs):
    """(mel, tokens, mask) of 2 examples: random mel, real transcripts."""
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((2, 80, 32)).astype(np.float32)
    rows = [TD.encode_example(t, tok, cfgs[1].decoder_ctx_size)
            for t in ("hello world", "hi there")]
    return (mel, np.stack([r[0] for r in rows]),
            np.stack([r[1] for r in rows]))


def _jbatch(b):
    return JT.Batch(*(jnp.asarray(x) for x in b))


def _tbatch(b):
    return TT.Batch(*(torch.from_numpy(x) for x in b))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30))


# The key bias (qkv_b[:, 1] and cross_kv_b[:, 0]) shifts every score of a
# query by the same amount, which the softmax removes: its gradient is zero
# up to f32 rounding noise (checked in test_gradients_*), and AdamW turns
# that noise into updates of up to the learning rate whose size depends on
# the noise itself. Those columns are compared apart, by that bound.
K_BIAS = {"decoder.blocks.qkv_b": (slice(None), 1),
          "encoder.blocks.qkv_b": (slice(None), 1),
          "decoder.blocks.cross_kv_b": (slice(None), 0)}


def _split_k_bias(name, a):
    """(a without its key-bias column, the column or None)."""
    if name not in K_BIAS:
        return a, None
    idx = K_BIAS[name]
    rest = np.delete(a, idx[1], axis=1)
    return rest, a[idx]


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_metrics_match_jax(cfgs, start, batch_np, remat):
    """The port's loss and metrics, without and with remat, against JAX's
    (one jitted loss; JAX's remat recomputes the same operations)."""
    jcfg, tcfg = cfgs
    want, _ = _jax_grads(jcfg, jax.tree.map(jnp.asarray, start),
                         _jbatch(batch_np))
    _, got = TT.cross_entropy_loss(trainable(start), _tbatch(batch_np),
                                   tcfg, remat)
    for key in ("loss", "accuracy", "tokens"):
        np.testing.assert_allclose(float(got[key].detach()), float(want[key]),
                                   rtol=LOSS_RTOL, err_msg=key)
    assert float(got["tokens"]) == float(batch_np[2][:, :-1].sum())


_jax_value_and_grad = jax.jit(
    jax.value_and_grad(JT.cross_entropy_loss, has_aux=True),
    static_argnums=(2, 3))


def _jax_grads(cfg, params, batch, remat=False):
    (_, metrics), grads = _jax_value_and_grad(params, batch, cfg, remat)
    return metrics, _flat(jax.tree.map(np.asarray, grads))


TRAJECTORY_OPT = dict(learning_rate=LR, weight_decay=WD, warmup_steps=WARMUP,
                      total_steps=TOTAL)


def _trajectory(make_step, init, value_and_grad, params_of):
    """3 steps from `init`: each step's (metrics, flat params) and the
    flat gradients before steps 1 and 2."""
    state, step = init, make_step()
    out = {"steps": [], "grads": []}
    for i in range(3):
        if i:
            out["grads"].append(value_and_grad(state.params))
        state, metrics = step(state)
        out["steps"].append((metrics, params_of(state.params)))
    out["state"] = state
    return out


@pytest.fixture(scope="module")
def jax_run(cfgs, start, batch_np):
    """JAX's 3-step trajectory (warmup 1: step 0 at learning rate 0),
    without remat: `jax.checkpoint` recomputes the same operations, so
    JAX's remat gives the same values and the port's remat is held
    against this run too."""
    jcfg = cfgs[0]
    jopt, jb = JT.make_optimizer(**TRAJECTORY_OPT), _jbatch(batch_np)
    return _trajectory(
        lambda: functools.partial(JT.make_train_step(jcfg, jopt), batch=jb),
        JT.init_train_state(jax.tree.map(jnp.asarray, start), jopt),
        lambda p: _jax_grads(jcfg, p, jb)[1],
        lambda p: _flat(jax.tree.map(np.asarray, p)))


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "remat"])
def runs(request, cfgs, start, batch_np, jax_run):
    """The port's 3 `make_train_step` steps from the same params and batch,
    without and with remat, beside JAX's: each step's metrics, the params
    after each step, and the gradients of every leaf before steps 1 and 2
    -- the second after an update with a nonzero learning rate, where a
    per-layer view kept from before that update would show."""
    remat, tcfg = request.param, cfgs[1]
    topt, tb = TT.make_optimizer(**TRAJECTORY_OPT), _tbatch(batch_np)
    port = _trajectory(
        lambda: functools.partial(TT.make_train_step(tcfg, topt, remat),
                                  batch=tb),
        TT.init_train_state(trainable(start), topt),
        lambda p: {n: g.numpy() for n, g in
                   TT.value_and_grad(p, tb, tcfg, remat)[1].items()},
        lambda p: _flat(numpy_tree(p)))
    return {"jax": jax_run["steps"], "torch": port["steps"],
            "grads": list(zip(port["grads"], jax_run["grads"])),
            "steps": (port["state"].step, int(jax_run["state"].step)),
            "count": port["state"].opt_state.count}


def test_gradients_match_jax_over_two_steps(runs):
    """Every leaf's gradient before steps 1 and 2, and the key bias's
    gradient at rounding-noise level in both packages."""
    for got, want in runs["grads"]:
        assert set(got) == set(want)
        scale = np.sqrt(sum(float((g * g).sum()) for g in want.values()))
        for name, g in want.items():
            assert _rel(got[name], g) <= GRAD_RTOL, name
            if name in K_BIAS:
                for k_grad in (g[K_BIAS[name]], got[name][K_BIAS[name]]):
                    assert np.abs(k_grad).max() <= 1e-6 * scale, name
    # the step between them moved the params
    assert any(_rel(runs["torch"][1][1][n], runs["torch"][0][1][n]) > 1e-6
               for n in runs["torch"][0][1])


def test_remat_matches_no_remat(cfgs, start, batch_np):
    tcfg = cfgs[1]
    params = trainable(start)
    m0, g0 = TT.value_and_grad(params, _tbatch(batch_np), tcfg, remat=False)
    m1, g1 = TT.value_and_grad(params, _tbatch(batch_np), tcfg, remat=True)
    np.testing.assert_allclose(float(m1["loss"]), float(m0["loss"]),
                               rtol=LOSS_RTOL)
    for name in g0:
        assert _rel(g1[name].numpy(), g0[name].numpy()) <= GRAD_RTOL, name


@pytest.mark.parametrize("warmup,total", [(3, 10), (0, 5), (5, 2), (1, 4)])
def test_schedule_matches_optax(warmup, total):
    want = optax.warmup_cosine_decay_schedule(0.0, LR, warmup,
                                              max(total, warmup + 1))
    opt = TT.make_optimizer(learning_rate=LR, warmup_steps=warmup,
                            total_steps=total)
    for count in range(total + 3):
        np.testing.assert_allclose(opt.schedule(count),
                                   float(want(jnp.int32(count))),
                                   rtol=SCHEDULE_RTOL, atol=1e-12)
    assert (opt.schedule(0) == 0.0) == (warmup > 0)


@pytest.mark.parametrize("max_norm", [100.0, 0.05], ids=["below", "above"])
def test_clipped_adamw_updates_match_optax(max_norm):
    """Two updates (count 0, learning rate 0; then count 1) of a small tree
    on fixed gradients whose global norm is below or above max_norm:
    params and both moments against optax's chain."""
    rng = np.random.default_rng(3)
    tree = {"w": rng.standard_normal((4, 5)).astype(np.float32),
            "sub": {"b": rng.standard_normal(7).astype(np.float32)}}
    grads = [{"w": rng.standard_normal((4, 5)).astype(np.float32) * 0.1,
              "sub": {"b": rng.standard_normal(7).astype(np.float32) * 0.1}}
             for _ in range(2)]
    kw = dict(learning_rate=LR, weight_decay=WD, warmup_steps=1,
              total_steps=TOTAL, max_grad_norm=max_norm)
    jopt = JT.make_optimizer(**kw)
    jp = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jp)
    topt = TT.make_optimizer(**kw)
    tp = trainable(tree)
    tstate = topt.init(tp)
    for g in grads:
        norm = float(optax.global_norm(g))
        assert (norm < max_norm) == (max_norm == 100.0)
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tstate = topt.update({n: torch.from_numpy(a.copy())
                              for n, a in _flat(g).items()}, tstate, tp)
    adam = jstate[1][0]
    for name, want in _flat(jax.tree.map(np.asarray, jp)).items():
        np.testing.assert_allclose(dict(tp.named_parameters())[name]
                                   .detach().numpy(), want, rtol=UPDATE_RTOL)
    for moment, want in (("mu", adam.mu), ("nu", adam.nu)):
        for name, w in _flat(jax.tree.map(np.asarray, want)).items():
            np.testing.assert_allclose(
                getattr(tstate, moment)[name].numpy(), w, rtol=UPDATE_RTOL,
                err_msg=f"{moment} {name}")
    assert tstate.count == int(adam.count) == 2


def test_params_after_three_steps_match_jax(runs, start):
    """Each step's metrics, then every leaf after 3 steps by relative L2,
    with the key-bias columns apart (K_BIAS): within 3 learning-rate
    steps."""
    for (tm, _), (jm, _) in zip(runs["torch"], runs["jax"]):
        for key in ("loss", "accuracy", "tokens", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=LOSS_RTOL, err_msg=key)
    assert runs["steps"] == (3, 3) and runs["count"] == 3
    got, want = runs["torch"][-1][1], runs["jax"][-1][1]
    for name, w in want.items():
        g_rest, g_k = _split_k_bias(name, got[name])
        w_rest, w_k = _split_k_bias(name, w)
        assert _rel(g_rest, w_rest) <= PARAM_RTOL, name
        if g_k is not None:
            assert np.abs(g_k - w_k).max() <= 3 * LR * (1 + 1e-3), name


def test_step_zero_leaves_params_unchanged(runs, start):
    """optax's schedule is read before its count increments: the first
    update has learning rate 0 (and so weight decay 0), in both
    packages."""
    for _, params in (runs["jax"][0], runs["torch"][0]):
        for name, a in _flat(start).items():
            np.testing.assert_array_equal(params[name], a, name)


def test_trainable_tree_views_follow_the_updates(start):
    """A trainable tree builds its per-layer views at every call: after an
    in-place update the new views read the new values; a serving tree
    keeps its cached views."""
    params = trainable(start)
    blocks = params["encoder"]["blocks"]
    before = blocks.layers()
    assert before is not blocks.layers()
    with torch.no_grad():
        blocks.qkv_w.add_(1.0)
    np.testing.assert_array_equal(blocks.layers()[1]["qkv_w"].detach(),
                                  start["encoder"]["blocks"]["qkv_w"][1] + 1)
    assert blocks.layers()[0]["qkv_w"].grad_fn is not None
    serving = from_numpy_tree(start)["encoder"]["blocks"]
    assert serving.layers() is serving.layers()
    assert not any(t.requires_grad for t in serving.buffers())
    # trainable copies torch leaves: the serving tree is never updated
    tree = trainable(from_numpy_tree(start))
    with torch.no_grad():
        tree["decoder"]["ln_g"].add_(1.0)
    assert float(from_numpy_tree(start)["decoder"]["ln_g"][0]) == 1.0


def test_trainer_refuses_flash_and_quantized_trees(cfgs, start):
    import dataclasses

    tcfg = dataclasses.replace(cfgs[1], attention="flash")
    with pytest.raises(ValueError, match="inference-only"):
        TT.make_train_step(tcfg, TT.make_optimizer())
    with pytest.raises(ValueError, match="quantized"):
        trainable(quantize_params(from_numpy_tree(start)))
    with pytest.raises(ValueError, match="trainable tree"):
        TT.init_train_state(from_numpy_tree(start), TT.make_optimizer())


def test_eval_step_matches_jax(cfgs, start, batch_np):
    jcfg, tcfg = cfgs
    want = JT.make_eval_step(jcfg)(jax.tree.map(jnp.asarray, start),
                                   _jbatch(batch_np))
    got = TT.make_eval_step(tcfg)(from_numpy_tree(start), _tbatch(batch_np))
    for key in ("loss", "accuracy", "tokens"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=LOSS_RTOL)
        assert got[key].grad_fn is None


# --------------------------------------------------------------------------
# Data
# --------------------------------------------------------------------------


@pytest.mark.parametrize("text", ["hello world", "hi", "", "word " * 3])
@pytest.mark.parametrize("task", ["transcribe", "translate"])
def test_encode_example_matches_jax(tok, jtok, text, task):
    got = TD.encode_example(text, tok, 24, "en", task)
    want = JD.encode_example(text, jtok, 24, "en", task)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    with pytest.raises(ValueError, match="n_text_ctx"):
        TD.encode_example("word " * 100, tok, 24)


def _assert_batches_equal(got, want):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.loss_mask.numpy(),
                                  np.asarray(want.loss_mask))
    np.testing.assert_allclose(got.mel.numpy(), np.asarray(want.mel),
                               atol=MEL_ATOL, rtol=0)


def test_build_batch_matches_jax(tok, jtok, cfgs):
    rng = np.random.default_rng(0)
    waves = [rng.standard_normal(3000).astype(np.float32),
             rng.standard_normal(20000).astype(np.float32)]  # truncated
    texts = ["hello", "hello world"]
    got = TD.build_batch(waves, texts, tok, cfgs[1])
    want = JD.build_batch(waves, texts, jtok, cfgs[0])
    _assert_batches_equal(got, want)
    assert got.mel.shape == (2, 80, cfgs[1].encoder_ctx_size)
    with pytest.raises(ValueError, match="pair up"):
        TD.build_batch(waves, texts[:1], tok, cfgs[1])


def test_iter_batches_match_jax(tok, jtok, cfgs, caplog):
    """Two epochs of shuffled batches, element for element, with an
    example past n_text_ctx dropped with one warning."""
    rng = np.random.default_rng(0)
    ex = [(rng.standard_normal(2000 + 500 * i).astype(np.float32), t)
          for i, t in enumerate(["hello", "hi", "hello world", "hey",
                                 "world"])]
    ex.append((ex[0][0], "word " * 100))
    # both packages' loggers hand their records to caplog directly: once a
    # JAX CLI test has run in this worker, `whisper_tpu.utils.logging.
    # configure` has turned the JAX logger's propagation off
    loggers = [logging.getLogger(n) for n in ("whisper_tpu_torch",
                                              "whisper_tpu")]
    for logger in loggers:
        logger.addHandler(caplog.handler)
    try:
        got = list(TD.iter_batches(ex, tok, cfgs[1], 2, seed=5, epochs=2))
        want = list(JD.iter_batches(ex, jtok, cfgs[0], 2, seed=5, epochs=2))
    finally:
        for logger in loggers:
            logger.removeHandler(caplog.handler)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)
    # a record may reach caplog's handler twice (here and through the root
    # logger): count each record once
    records = {id(r): r for r in caplog.records
               if r.levelno == logging.WARNING}.values()
    assert len(records) == 2
    assert {r.name: r.getMessage() for r in records} == {
        "whisper_tpu_torch.training.data":
            "dropped 1/6 examples exceeding n_text_ctx=24",
        "whisper_tpu.training.data":
            "dropped 1/6 examples exceeding n_text_ctx=24"}
    with pytest.raises(ValueError, match="too few|usable examples"):
        next(TD.iter_batches(ex[:1], tok, cfgs[1], batch_size=4))


def _jax_bands(key, b, size, width, count):
    """JAX's `band_mask` draws (whisper_tpu/training/data.py:123-128)."""
    kw, ks = jax.random.split(key)
    w = jax.random.randint(kw, (count, b), 0, width + 1)
    start = jax.random.randint(ks, (count, b), 0,
                               jnp.maximum(size - w + 1, 1))
    return (torch.from_numpy(np.asarray(start).astype(np.int64)),
            torch.from_numpy(np.asarray(w).astype(np.int64)))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("widths", [(27, 100), (10, 20), (80, 120)])
def test_spec_augment_masking_matches_jax(seed, widths):
    """JAX's draws, reproduced from its key splits, through the port's
    masking: the output equals JAX's `spec_augment`."""
    scfg = TD.SpecAugmentConfig(2, widths[0], 2, widths[1])
    jscfg = JD.SpecAugmentConfig(2, widths[0], 2, widths[1])
    mel = np.random.default_rng(seed).standard_normal(
        (3, 80, 100)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(JD.spec_augment(jnp.asarray(mel), key, jscfg))
    kf, kt = jax.random.split(key)
    fs, fw = _jax_bands(kf, 3, 80, scfg.freq_mask_width, scfg.n_freq_masks)
    ts, tw = _jax_bands(kt, 3, 100, scfg.time_mask_width, scfg.n_time_masks)
    got = TD.mask_bands(torch.from_numpy(mel), fs, fw, ts, tw).numpy()
    np.testing.assert_array_equal(got != mel, want != mel)
    # the fill is an f32 mean of 8000 values, summed in another order
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_spec_augment_draws_per_generator_seed():
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 80, 100)).astype(np.float32))
    scfg = TD.SpecAugmentConfig(1, 10, 1, 20)

    def run(seed):
        return TD.spec_augment(mel, torch.Generator().manual_seed(seed), scfg)

    a, b = run(0), run(0)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, run(1))
    changed = a != mel
    fill = mel.mean(dim=(1, 2))
    for i in range(2):
        assert torch.all(a[i][changed[i]] == fill[i])
    # one band each way: at most 10 mel rows and 20 frames
    assert changed.float().mean() <= (10 * 100 + 20 * 80) / (80 * 100)
    # the bounds include `width`, and the start's bound varies per element
    gen = torch.Generator().manual_seed(0)
    start, w = TD._draw_bands(gen, 4000, 30, 29, 1)
    assert int(w.max()) == 29 and int(w.min()) == 0
    assert bool((start + w <= 30).all()) and bool((start >= 0).all())
    assert bool(((start + w) == 30).any())


# --------------------------------------------------------------------------
# Debug and profiling helpers
# --------------------------------------------------------------------------


def test_debug_nans_raises_on_the_first_nan():
    x = torch.tensor([1.0, -1.0])
    with debug.debug_nans():
        y = torch.exp(x)  # finite: passes
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(-x)
        with debug.debug_nans(False):
            assert bool(torch.isnan(torch.log(-x)).any())
    assert bool(torch.isnan(torch.log(-x)).any())  # off outside
    assert bool(torch.isfinite(y).all())


def test_assert_all_finite_names_the_path(cfgs, start):
    params = trainable(start)
    state = TT.init_train_state(params, TT.make_optimizer())
    debug.assert_all_finite(state, "state")
    debug.assert_all_finite(start, "numpy")
    with torch.no_grad():
        params["decoder"]["blocks"]["mlp2_b"][0, 3] = float("inf")
    for tree, where in ((state, "state: non-finite values at "
                         "params/decoder/blocks/mlp2_b"),
                        (params, "decoder/blocks/mlp2_b"),
                        (numpy_tree(params), "decoder/blocks/mlp2_b")):
        with pytest.raises(FloatingPointError, match=where):
            debug.assert_all_finite(tree, "state")
    state.opt_state.nu["encoder.conv1_b"][0] = float("nan")
    with torch.no_grad():
        params["decoder"]["blocks"]["mlp2_b"][0, 3] = 0.0
    with pytest.raises(FloatingPointError, match="opt_state/nu/encoder"):
        debug.assert_all_finite(state)


def test_trace_records_a_named_scope(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.scope("encoder_pass"):
            torch.ones(8, 8) @ torch.ones(8, 8)
        with profiling.scope("host_step"):
            torch.zeros(3).sum()
    files = list(Path(tmp_path).glob("*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())[
        "traceEvents"]}
    assert {"encoder_pass", "host_step"} <= names
    with profiling.trace(None):  # a no-op
        pass
