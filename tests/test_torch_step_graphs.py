"""The greedy decoder's captured step (`decode/step_graphs.py`) on the CPU:
which calls `eager_reason` keeps eager, the fused S = 1 step at a (B,)
device position against the same step at an int position, the graphed
argmax loop over a held state (its steps run eagerly off the card)
against the eager loop token for token, the spans it records, and the
bounds on the held states.

Setup: a 2-layer n_state-64 model from the port's `init_params` with its
matrices scaled up 20x so that the rows choose different tokens, on a
random (B, 16, 64) encoder output, attention="flash" (the kernels' plain
versions on the CPU). The card's tests of the same loop, where the steps
are graph replays, are at the end, marked `cuda`.
"""

import contextlib
import dataclasses
import gc
import weakref

import pytest
import torch

from whisper_tpu_torch.config import tiny_test_config
from whisper_tpu_torch.decode import greedy as G
from whisper_tpu_torch.decode import step_graphs as SG
from whisper_tpu_torch.models import whisper as M
from whisper_tpu_torch.params import init_params
from whisper_tpu_torch.parallel import context as pctx
from whisper_tpu_torch.utils import profiling

N_VOCAB = 64
PROMPT = (1, 2, 3)
EOT = 0  # some rows choose it mid-decode (checked below)
UNTIL = 5  # suppression window: seq len <= 5
DEPTH = 12


def _cfg(attention="flash", n_state=64, n_head=2, n_vocab=N_VOCAB,
         n_text_ctx=24):
    return dataclasses.replace(
        tiny_test_config(n_state=n_state, n_head=n_head, n_vocab=n_vocab,
                         n_text_ctx=n_text_ctx), attention=attention)


def _params(cfg, seed=0, device=None, dtype=torch.float32):
    params = init_params(cfg, torch.Generator(device=device or "cpu")
                         .manual_seed(seed), dtype=dtype, device=device)
    with torch.no_grad():
        for t in params.buffers():
            if t.dim() >= 2:
                t.mul_(20)
    return params


@pytest.fixture(scope="module")
def model():
    cfg = _cfg()
    return cfg, _params(cfg)


def _enc(b, seed=1, d=64, dtype=torch.float32, device=None):
    g = torch.Generator(device=device or "cpu").manual_seed(seed)
    return 3 * torch.randn(b, 16, d, generator=g, device=device).to(dtype)


def _mask(n_vocab=N_VOCAB, device=None):
    m = torch.zeros(n_vocab, device=device)
    m[40:] = float("-inf")  # 57, the rows' first choice, among them
    return m


def _decode(params, cfg, enc, **kw):
    kw = {"eot_id": EOT, "suppress_mask": _mask(), "max_depth": DEPTH,
          "suppress_until_len": UNTIL, **kw}
    return G.greedy_decode(params, enc, torch.tensor(PROMPT), cfg, **kw)


# ---------------------------------------------------------------------------
# the engagement rule
# ---------------------------------------------------------------------------


CONDITIONS = {
    "sampling (temperature > 0)": dict(
        temperature=0.5, generator=torch.Generator().manual_seed(0)),
    "a logits hook": dict(logits_hook=lambda x, tokens, seq_len: x),
    "timestamp rules": dict(ts_begin=50),
    "a quantized cross cache": dict(kv_quant=True),
    "not the fused S = 1 step (attention != 'flash')": dict(attention="xla"),
    "a mesh": dict(mesh=True),
    "grad enabled": dict(grad=True),
    "not on a CUDA device": {},
}


@pytest.mark.parametrize("reason", list(CONDITIONS))
def test_each_condition_keeps_the_steps_eager(model, reason):
    """Each condition of `eager_reason` alone (the CPU last of them) keeps
    the loop eager, and `eager_steps` counts its decoder steps."""
    cfg, params = model
    kw = dict(CONDITIONS[reason])
    if kw.pop("attention", None):
        cfg = dataclasses.replace(cfg, attention="xla")
    mesh, grad = kw.pop("mesh", False), kw.pop("grad", False)
    enc = _enc(3)
    before = (G.greedy_decode.eager_steps, G.greedy_decode.graph_steps,
              G.greedy_decode.graph_captures)
    with torch.set_grad_enabled(grad), (
            pctx.dp_rows(0, 3) if mesh else contextlib.nullcontext()):
        got = G.eager_reason(enc, cfg, kw.get("temperature", 0.0),
                             kw.get("logits_hook"), kw.get("ts_begin"),
                             kw.get("kv_quant", False))
        out = _decode(params, cfg, enc, **kw)
    assert got == reason
    # a decoder step per token after the first
    steps = int(out[1].max()) - len(PROMPT) - 1
    assert (G.greedy_decode.eager_steps - before[0],
            G.greedy_decode.graph_steps - before[1],
            G.greedy_decode.graph_captures - before[2]) == (steps, 0, 0)


# ---------------------------------------------------------------------------
# the fused step at a device position
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("self_quant", [False, "int8", "int4"])
def test_device_position_step_equals_the_int_position_step(model, self_quant):
    """`_decoder_step_fused` at a (B,) int32 position tensor gives the
    logits and writes the cache rows of the same step at the int
    position, after the same prompt step; no other row changes."""
    cfg, params = model
    enc = _enc(4)
    tokens = torch.tensor([PROMPT] * 4)
    nxt = torch.tensor([[7], [9], [11], [13]])
    pos = len(PROMPT)
    outs = []
    with torch.no_grad():
        for at in (pos, torch.full((4,), pos, dtype=torch.int32)):
            cache = M.init_cache(params, enc, cfg, cache_len=16,
                                 self_quant=self_quant)
            M.decoder_step(params, tokens, 0, cache, cfg)
            logits, cache = M._decoder_step_fused(params, nxt, at, cache, cfg)
            outs.append((logits, cache))
    (want, c0), (got, c1) = outs
    assert torch.equal(got, want)
    for a, b in zip(c0, c1):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)
    rows = M._arr(c1.self_k)[:, :, pos]
    assert rows.float().abs().sum() > 0  # the step wrote its rows


def test_a_tensor_position_takes_only_the_fused_step(model):
    cfg, params = model
    cache = M.init_cache(params, _enc(2), cfg, cache_len=16)
    at = torch.zeros(2, dtype=torch.int32)
    with torch.no_grad(), pytest.raises(ValueError, match="S=1 flash"):
        M.decoder_step(params, torch.tensor([[1], [2]]), at, cache,
                       dataclasses.replace(cfg, attention="xla"))


def test_init_cache_fills_a_given_cache_in_place(model):
    """`init_cache(out=)` writes the cross K/V of the new encoder output
    into the given arrays, zeroes the self cache, and returns it."""
    cfg, params = model
    with torch.no_grad():
        out = M.init_cache(params, _enc(2, seed=5), cfg, cache_len=16)
        out.self_k.fill_(3.0)
        want = M.init_cache(params, _enc(2), cfg, cache_len=16)
        got = M.init_cache(params, _enc(2), cfg, cache_len=16, out=out)
    assert got is out
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unquantized"):
        M.init_cache(params, _enc(2), cfg, cache_len=16, kv_quant=True,
                     out=out)


# ---------------------------------------------------------------------------
# the graphed loop, its steps run eagerly off the card
# ---------------------------------------------------------------------------


def _graphed(graphs, params, cfg, enc, self_quant=False, depth=DEPTH,
             nospeech_id=None, eot=EOT):
    """`greedy_decode`'s loop over `graphs`' state for the call's key."""
    n = len(PROMPT)
    return G._decode(
        graphs, params, enc, torch.tensor(PROMPT), cfg, eot, _mask(),
        enc.shape[0], 128, min(cfg.text_decoder_config.n_text_ctx, n + depth),
        UNTIL, False, self_quant, None, 50, 0.0, None, nospeech_id, 0, None)


@pytest.mark.parametrize("b,self_quant", [(1, False), (5, False),
                                          (5, "int8"), (5, "int4")])
def test_graphed_loop_equals_the_eager_loop(model, b, self_quant):
    """The device-position loop over one key's state gives the eager
    loop's tokens, lengths, sums and p(nospeech), twice under one key on
    two encoder outputs (the second call refills every buffer), across the
    suppression window, with rows that stop early on EOT."""
    cfg, params = model
    graphs = SG.StepGraphs()
    stopped = False
    with torch.inference_mode():
        for seed in (1, 2):
            enc = _enc(b, seed=seed)
            want = _decode(params, cfg, enc, self_quant=self_quant,
                           nospeech_id=9)
            got = _graphed(graphs, params, cfg, enc, self_quant, nospeech_id=9)
            for x, y in zip(want, got):
                assert torch.equal(x, y)
            stopped |= bool((want[1] < len(PROMPT) + DEPTH).any())
    assert len(graphs) == 1
    if b == 5:
        assert stopped  # some row ended on EOT before max_depth


def test_graphed_loop_ends_when_every_row_is_done(model):
    """All rows done before max_depth: the loop stops at the same read as
    the eager loop, with the same outputs."""
    cfg, params = model
    enc = _enc(5)
    n = len(PROMPT)
    with torch.inference_mode():
        probe = _decode(params, cfg, enc, max_depth=20, eot_id=N_VOCAB - 1)[0]
        # a token every row chooses: as EOT, it ends them all
        eot = next(t for t in range(N_VOCAB)
                   if bool((probe[:, n + 2:n + 16] == t).any(dim=1).all()))
        want = _decode(params, cfg, enc, max_depth=20, eot_id=eot)
        got = _graphed(SG.StepGraphs(), params, cfg, enc, depth=20, eot=eot)
    assert int(want[1].max()) < n + 20
    for x, y in zip(want, got):
        assert torch.equal(x, y)


def test_graphed_loop_records_the_eager_loops_spans(model):
    """Under a profiler the graphed loop's spans nest as the eager loop's:
    prefill and steps inside the decode, each read inside a step."""
    from torch.profiler import ProfilerActivity, profile

    cfg, params = model
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU]) as prof:
        with profiling.scope("whisper.decode"):
            _graphed(SG.StepGraphs(), params, cfg, _enc(2), depth=6)
    spans = sorted(((e.time_range.start, -e.time_range.end, e.name)
                    for e in prof.events() if e.name.startswith("whisper.")))
    names = [n for _, _, n in spans]
    steps = (len(names) - 2) // 2
    assert steps >= 2
    assert names[:2] == ["whisper.decode", "whisper.decode.prefill"]
    assert names[2:] == ["whisper.decode.step", "whisper.decode.sync"] * steps
    ends = {i: -e for i, (_, e, _) in enumerate(spans)}
    for i in range(2, len(spans), 2):  # each read within its step
        assert spans[i][0] <= spans[i + 1][0] and ends[i + 1] <= ends[i]


def test_step_graphs_keep_at_most_max_keys(model):
    """The least recently used key goes first; `get` refreshes a key; an
    evicted state's buffers are freed."""
    cfg, params = model
    graphs = SG.StepGraphs(max_keys=2)
    with torch.inference_mode():
        for b in (1, 2):
            _graphed(graphs, params, cfg, _enc(b), depth=3)
        first = next(iter(graphs._states.values()))
        freed = weakref.ref(first.tokens)
        del first
        key_b2 = list(graphs._states)[1]
        assert graphs.get(key_b2) is not None  # b = 2 now most recent
        _graphed(graphs, params, cfg, _enc(3), depth=3)
    gc.collect()
    assert len(graphs) == 2 and key_b2 in graphs._states
    assert freed() is None
    graphs.clear()
    assert len(graphs) == 0


def test_a_new_state_is_made_after_the_eviction():
    """`add` evicts the least recently used states down to the bounds
    before it makes the new one, so the two never coexist."""
    graphs = SG.StepGraphs(max_keys=2)
    made = []

    def make(tag):
        def _make():
            gc.collect()
            made.append((tag, sorted(graphs._states),
                         [r() is None for r in refs]))
            cache = M.DecoderCache(*(torch.zeros(2, 4) for _ in range(4)))
            return SG.StepState(cache, 2, 8, 16, None)
        return _make

    refs = []
    for tag in ("a", "b"):
        state = graphs.add(tag, torch.device("cpu"), 0, make(tag))
        refs.append(weakref.ref(state.tokens))
        del state
    graphs.add("c", torch.device("cpu"), 0, make("c"))
    assert made[-1] == ("c", ["b"], [True, False])


def test_a_state_larger_than_the_share_runs_eagerly(model, monkeypatch):
    """A key whose state alone exceeds the held share is neither held nor
    evicts anything: its call runs the eager loop with a fresh state."""
    cfg, params = model
    graphs = SG.StepGraphs()
    with torch.inference_mode():
        _graphed(graphs, params, cfg, _enc(2), depth=3)
        kept = list(graphs._states)
        enc = _enc(3)
        need = G._state_nbytes(params, enc, cfg, 3, 128, False)
        monkeypatch.setattr(SG.StepGraphs, "limit",
                            staticmethod(lambda device: need - 1))
        before = G.greedy_decode.eager_steps
        got = _graphed(graphs, params, cfg, enc)
        want = _decode(params, cfg, enc)
    assert list(graphs._states) == kept
    for x, y in zip(want, got):
        assert torch.equal(x, y)
    steps = int(want[1].max()) - len(PROMPT) - 1
    assert G.greedy_decode.eager_steps - before == 2 * steps


@pytest.mark.parametrize("self_quant", [False, "int8", "int4"])
def test_state_nbytes_counts_the_states_buffers(model, self_quant):
    """The size `add` is told before the state exists is that of the state
    made, less its (B,) and (V,) vectors."""
    cfg, params = model
    enc = _enc(3)
    want = G._new_state(params, enc, cfg, 6, 128, False, self_quant,
                        _mask()).nbytes()
    got = G._state_nbytes(params, enc, cfg, 6, 128, self_quant)
    assert got <= want <= got + 6 * 64 + 4 * N_VOCAB + 64


# ---------------------------------------------------------------------------
# on the card: the steps are graph replays
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (graph capture and the kernels)")
    SG.STEP_GRAPHS.clear()
    yield torch.device("cuda")
    SG.STEP_GRAPHS.clear()


def _card_model(card, vocab=1024):
    """bf16 weights at head dim 64 (what the kernels take), 2 layers."""
    cfg = _cfg(n_state=256, n_head=4, n_vocab=vocab, n_text_ctx=64)
    params = _params(cfg, device=card, dtype=torch.bfloat16)
    return cfg, params


def _eot_mid_decode(tokens, n):
    """A token that some rows, not all, choose four or more positions
    after the prompt: as EOT, it ends those rows early, past the
    suppression window (both branch phases run first)."""
    body = tokens[:, n + 4:n + 12]
    for t in torch.unique(body).tolist():
        hit = (body == t).any(dim=1)
        if 0 < int(hit.sum()) < tokens.shape[0] or tokens.shape[0] == 1:
            return t
    return int(body[0, 0])


def _card_decode(params, cfg, enc, eot, depth=24):
    mask = torch.zeros(cfg.text_decoder_config.n_vocab, device=enc.device)
    mask[-24:] = float("-inf")
    prompt = torch.tensor(PROMPT, device=enc.device)
    return G.greedy_decode(params, enc, prompt, cfg, eot_id=eot,
                           suppress_mask=mask,
                           max_depth=depth, suppress_until_len=UNTIL)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 5, 128])
def test_graph_replays_equal_the_eager_loop_on_the_card(card, b):
    """Graphed greedy decoding on the card equals the eager loop (forced by
    holding the graphs' lock, as a concurrent decode does) token for
    token, with equal lengths and sums, across the suppression window and
    with rows stopping on EOT; a second call under the same key on another
    encoder output gives that output's eager result, every step a replay;
    the kernel wrappers' counters count none of the replays."""
    from whisper_tpu_torch.ops.kernels import decode_attention as KC

    cfg, params = _card_model(card)
    stopped = False
    with torch.inference_mode():
        with SG.STEP_GRAPHS.lock:
            probe = _card_decode(params, cfg, _enc(b, 1, 256, torch.bfloat16,
                                                   card), eot=1023)
        eot = _eot_mid_decode(probe[0], len(PROMPT))
        for seed in (1, 2):
            enc = _enc(b, seed, 256, torch.bfloat16, card)
            k3 = KC.decode_attention_stacked.launches
            with SG.STEP_GRAPHS.lock:
                want = _card_decode(params, cfg, enc, eot)
            k3_eager = KC.decode_attention_stacked.launches - k3
            steps = (G.greedy_decode.graph_steps,
                     G.greedy_decode.graph_captures)
            got = _card_decode(params, cfg, enc, eot)
            k3_graph = KC.decode_attention_stacked.launches - k3 - k3_eager
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
            torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=0)
            n_steps = int(want[1].max()) - len(PROMPT) - 1
            if seed == 2:  # every step of the second call a replay
                assert G.greedy_decode.graph_steps - steps[0] == n_steps
                assert G.greedy_decode.graph_captures == steps[1]
                # self and cross attention a layer a step, eager only
                n_layer = cfg.text_decoder_config.n_text_layer
                assert k3_eager - k3_graph == 2 * n_layer * n_steps
            stopped |= bool((want[1] < len(PROMPT) + 24).any())
    assert stopped  # some row ended on EOT before max_depth
    assert len(SG.STEP_GRAPHS) == 1


@pytest.mark.cuda
def test_a_state_past_the_share_stays_eager_on_the_card(card, monkeypatch):
    """With the share below one state's size the decode holds nothing and
    replays nothing, and gives the eager loop's tokens."""
    cfg, params = _card_model(card)
    monkeypatch.setattr(SG, "MEMORY_SHARE", 1e-9)
    enc = _enc(5, 1, 256, torch.bfloat16, card)
    with torch.inference_mode():
        with SG.STEP_GRAPHS.lock:
            want = _card_decode(params, cfg, enc, 1023)
        replays = G.greedy_decode.graph_steps
        got = _card_decode(params, cfg, enc, 1023)
    assert G.greedy_decode.graph_steps == replays
    assert len(SG.STEP_GRAPHS) == 0
    for x, y in zip(want, got):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_graph_keys_stay_at_their_bound_on_the_card(card, monkeypatch):
    """Three batch sizes through a set of two keys: two states remain, the
    first one's buffers are freed, and its memory with them."""
    cfg, params = _card_model(card)
    monkeypatch.setattr(SG.STEP_GRAPHS, "max_keys", 2)
    with torch.inference_mode():
        _card_decode(params, cfg, _enc(64, 1, 256, torch.bfloat16, card), 1023)
        first = weakref.ref(next(iter(SG.STEP_GRAPHS._states.values())).cache
                            .cross_k)
        for b in (2, 3):
            _card_decode(params, cfg, _enc(b, 1, 256, torch.bfloat16, card),
                         1023)
    gc.collect()
    assert len(SG.STEP_GRAPHS) == 2
    assert first() is None
