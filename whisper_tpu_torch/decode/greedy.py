"""Batched greedy decoding with a KV cache, in PyTorch.

Counterpart of `whisper_tpu/decode/greedy.py::greedy_decode` (and the
helpers it takes from `decode/beam.py`): the special-token suppression
window (mask while seq len <= 5, src/transcribe.rs:271-275), the
timestamp rules, a custom logits hook, and per-row EOT stops -- finished
rows keep emitting EOT and the loop ends when every row is done or at
`max_len`. The JAX loop is an on-device `lax.while_loop`; here it is a
Python loop over steps that reads the `done` flags back each step.
With temperature > 0 each token is drawn from softmax(logp / T) through an
explicit `torch.Generator` (`sample_tokens`), the sampling rung of the
fallback ladder (pipeline/transcribe.py).

One loop (`_decode`) runs over a state of in-place buffers
(`decode/step_graphs.py::StepState`), one step a call of `_step`. On the
card, where `eager_reason` finds nothing against it, the argmax loop
replays each step as a captured CUDA graph with the position on the
device (`decode/step_graphs.py`); otherwise the steps run eagerly at int
positions. Both give the same tokens. `greedy_decode.graph_steps`,
`.eager_steps` and `.graph_captures` count the steps each way and the
captures.
"""

from __future__ import annotations

import functools
import itertools
from typing import Callable, Optional, Tuple

import torch

from ..config import WhisperConfig
from ..models import whisper as M
from ..parallel import context as pctx
from ..utils.profiling import scope
from .step_graphs import STEP_GRAPHS, StepGraphs, StepState

NEG_INF = float("-inf")


def sample_tokens(logp: torch.Tensor, temperature: float,
                  generator: torch.Generator) -> torch.Tensor:
    """One token per row drawn from softmax(logp / temperature), (B, V) ->
    (B,) int64, with `generator` (on logp's device). Suppressed (-inf)
    tokens have probability 0 and are never drawn. JAX draws with
    `jax.random.categorical` from a PRNG key; the two generators give
    different numbers, so the draws never equal JAX's: only their
    distribution does.

    The draw is `torch.multinomial`'s one-sample path written out:
    argmax(p / q) with q ~ Exp(1) filled over the (rows, V) batch. When
    the batch is split over dp (`parallel/context.dp_rows`), every rank
    fills the whole batch's q and keeps its rows, so each row draws what
    it draws in the meshless batch."""
    probs = torch.softmax(logp / temperature, dim=-1)
    first, total = pctx.dp_shard() or (0, probs.shape[0])
    q = torch.empty((total, probs.shape[1]), dtype=probs.dtype,
                    device=probs.device).exponential_(generator=generator)
    return torch.argmax(probs / q[first:first + probs.shape[0]], dim=-1)


def apply_timestamp_rules(logits: torch.Tensor, tokens: torch.Tensor,
                          seq_len: int, prompt_len: int, ts_begin: int,
                          eot_id: int, max_initial_idx: int) -> torch.Tensor:
    """OpenAI Whisper's timestamp logit constraints, as in
    `whisper_tpu/decode/beam.py::apply_timestamp_rules`: timestamp pairs,
    monotonic timestamps, a capped timestamp first, and the
    sum-of-logprobs rule. logits (B, V) f32, tokens (B, ctx)."""
    b, v = logits.shape
    device = logits.device
    ids = torch.arange(v, device=device)
    is_ts = (ids >= ts_begin)[None, :]
    no = torch.zeros(b, dtype=torch.bool, device=device)
    last_is_ts = (tokens[:, seq_len - 1] >= ts_begin
                  if seq_len >= prompt_len + 1 else no)
    pen_is_ts = (tokens[:, max(seq_len - 2, 0)] >= ts_begin
                 if seq_len >= prompt_len + 2 else no)

    closed = last_is_ts & pen_is_ts  # a pair just closed: no third stamp
    opened = last_is_ts & ~pen_is_ts  # one stamp open: stamp or EOT only
    logits = logits.masked_fill(closed[:, None] & is_ts, NEG_INF)
    logits = logits.masked_fill(
        opened[:, None] & ~is_ts & (ids != eot_id)[None, :], NEG_INF)

    pos = torch.arange(tokens.shape[1], device=device)
    sampled = ((pos >= prompt_len) & (pos < seq_len))[None, :]
    ts_vals = torch.where(sampled & (tokens >= ts_begin), tokens,
                          torch.full_like(tokens, -1))
    ts_last = ts_vals.max(dim=1).values
    floor = torch.where(opened, ts_last, ts_last + 1)
    logits = logits.masked_fill(
        (ts_last >= 0)[:, None] & is_ts & (ids[None, :] < floor[:, None]),
        NEG_INF)

    if seq_len == prompt_len:  # first sampled token: a capped timestamp
        logits = logits.masked_fill(~is_ts, NEG_INF)
        logits = logits.masked_fill(
            (ids > ts_begin + max_initial_idx)[None, :], NEG_INF)

    lp = torch.log_softmax(logits, dim=-1)
    ts_lp = torch.logsumexp(lp.masked_fill(~is_ts, NEG_INF), dim=-1)
    text_max = lp.masked_fill(is_ts, NEG_INF).max(dim=-1).values
    force_ts = ts_lp > text_max
    return logits.masked_fill(force_ts[:, None] & ~is_ts, NEG_INF)


def make_masked_logits_fn(prompt_len: int, eot_id: int,
                          suppress_mask: Optional[torch.Tensor],
                          suppress_until_len: int, ts_begin: Optional[int],
                          max_initial_ts_idx: int,
                          logits_hook: Optional[Callable]):
    """The token-selection rule `(logits (B, V), tokens (B, ctx), seq_len)
    -> f32 logits (B, V)`: the suppression window (src/transcribe.rs:
    271-276), then the timestamp rules, then the custom hook. Greedy and
    speculative decoding take its log-softmax (`make_logp_fn`); beam
    search its per-lane top-K and logsumexp (`decode/beam.py`)."""

    def _masked(logits, tokens, seq_len: int):
        x = logits.float()
        if suppress_mask is not None and seq_len <= suppress_until_len:
            x = x + suppress_mask
        if ts_begin is not None:
            x = apply_timestamp_rules(x, tokens, seq_len, prompt_len,
                                      ts_begin, eot_id, max_initial_ts_idx)
        if logits_hook is not None:
            x = logits_hook(x, tokens, seq_len)
        return x

    return _masked


def make_logp_fn(*args):
    """The token-selection distribution `(logits, tokens, seq_len, out=None)
    -> logp (B, V)`: the f32 log-softmax of `make_masked_logits_fn(*args)`."""
    masked = make_masked_logits_fn(*args)

    def _logp(logits, tokens, seq_len: int, out=None):
        return torch.log_softmax(masked(logits, tokens, seq_len), dim=-1,
                                 out=out)

    return _logp


def eager_reason(enc_out: torch.Tensor, cfg: WhisperConfig,
                 temperature: float, logits_hook: Optional[Callable],
                 ts_begin: Optional[int], kv_quant) -> Optional[str]:
    """Why `greedy_decode` runs its steps eagerly rather than as a captured
    graph, or None where the graph runs: it takes the argmax step of the
    fused S = 1 path on the card, with no logits hook, no timestamp rules,
    an unquantized cross cache (filled in place), no mesh (its collectives
    cannot be captured) and grad disabled."""
    if temperature != 0.0:
        return "sampling (temperature > 0)"
    if logits_hook is not None:
        return "a logits hook"
    if ts_begin is not None:
        return "timestamp rules"
    if kv_quant:
        return "a quantized cross cache"
    if cfg.attention != "flash":
        return "not the fused S = 1 step (attention != 'flash')"
    if pctx.active_mesh() is not None or pctx.dp_shard() is not None:
        return "a mesh"
    if torch.is_grad_enabled():
        return "grad enabled"
    if not enc_out.is_cuda:
        return "not on a CUDA device"
    return None


def _graph_key(params, enc_out: torch.Tensor, b: int, cache_len: int,
               self_quant, eot_id: int, suppress_mask, cfg: WhisperConfig):
    """What the captured step observes (decode/step_graphs.py)."""
    dec = params["decoder"]
    weights = tuple((t.data_ptr(), t.dtype, tuple(t.shape))
                    for t in itertools.chain(dec.parameters(), dec.buffers()))
    mask = (None if suppress_mask is None
            else (suppress_mask.dtype, tuple(suppress_mask.shape)))
    return (enc_out.device, enc_out.dtype, tuple(enc_out.shape), b,
            cache_len, self_quant, eot_id, mask, cfg, weights)


def _state_nbytes(params, enc_out: torch.Tensor, cfg: WhisperConfig,
                  b: int, cache_len: int, self_quant) -> int:
    """The bytes of the state `_new_state` makes: the caches at
    `init_cache`'s shapes (an unquantized cross cache), tokens, logp."""
    dec_cfg = cfg.text_decoder_config
    emb = params["decoder"]["tok_emb"]
    n_vocab, d = emb.shape
    n_layer, ctx = dec_cfg.n_text_layer, dec_cfg.n_text_ctx
    b_enc, sa = enc_out.shape[:2]
    rows = b * n_layer * min(cache_len, ctx)  # self cache rows of K (of V)
    if not self_quant:
        self_bytes = rows * d * emb.element_size()
    else:  # int8 or packed int4 rows and f32 row scales
        self_bytes = rows * (d // (2 if self_quant == "int4" else 1) + 4)
    cross_bytes = n_layer * b_enc * sa * d * emb.element_size()
    return 2 * (self_bytes + cross_bytes) + b * (ctx * 8 + n_vocab * 4)


def _new_state(params, enc_out, cfg: WhisperConfig, b: int, cache_len: int,
               kv_quant, self_quant, mask) -> StepState:
    """A state over a new cache of `enc_out`'s cross K/V."""
    cache = M.init_cache(params, enc_out, cfg, batch=b, cache_len=cache_len,
                         kv_quant=kv_quant, self_quant=self_quant)
    return StepState(cache, b, cfg.text_decoder_config.n_text_ctx,
                     params["decoder"]["tok_emb"].shape[0], mask)


def _choose(st: StepState, eot_id: int, temperature: float = 0.0,
            generator: Optional[torch.Generator] = None) -> None:
    """The token choice from `st.logp` and the rows' bookkeeping, in place,
    the token written at the device position `st.pos`: argmax (first index
    on ties, as jnp) or, at temperature > 0, a draw; rows already done
    emit EOT and keep their length and sum."""
    if temperature > 0.0:
        st.tok.copy_(sample_tokens(st.logp, temperature, generator))
    else:
        torch.argmax(st.logp, dim=-1, out=st.tok)
    tok_logp = st.logp.gather(1, st.tok[:, None])[:, 0]
    st.tok.masked_fill_(st.done, eot_id)
    st.tokens.scatter_(1, st.pos.long()[:, None], st.tok[:, None])
    torch.where(st.done, st.length, st.length + 1, out=st.length)
    torch.where(st.done, st.sum_logp, st.sum_logp + tok_logp,
                out=st.sum_logp)
    st.done.logical_or_(st.tok == eot_id)
    torch.all(st.done, out=st.all_done)


def _step(params, cfg: WhisperConfig, st: StepState, logp_fn, seq_len: int,
          eot_id: int, temperature: float, generator, at) -> None:
    """One step of the loop: the decoder step at the last token's position
    `at` (the int seq_len - 1 eagerly, the device `st.pos` in a graph),
    the distribution at `seq_len` (which picks the branch phase), the
    position advanced, then the next token chosen."""
    logits, _ = M.decoder_step(params, st.tok[:, None], at, st.cache, cfg)
    logp_fn(logits[:, -1], st.tokens, seq_len, out=st.logp)
    st.pos.add_(1)
    _choose(st, eot_id, temperature, generator)


def _decode(graphs: Optional[StepGraphs], params, enc_out, prompt, cfg,
            eot_id, suppress_mask, b, cache_len, max_len, suppress_until_len,
            kv_quant, self_quant, ts_begin, max_initial_ts_idx, temperature,
            generator, nospeech_id, sot_pos, logits_hook):
    """`greedy_decode`'s loop over a state: a fresh one whose steps run
    eagerly at int positions (`graphs` None), or the key's held one in
    `graphs`, each step a graph replay at the device position."""
    n_prompt = prompt.shape[0]
    held = False
    with scope("whisper.decode.prefill"):
        if graphs is not None:
            key = _graph_key(params, enc_out, b, cache_len, self_quant,
                             eot_id, suppress_mask, cfg)
            st = graphs.get(key)
            if st is None:
                def make():
                    # buffers that any later call may update in place
                    with torch.inference_mode(False), torch.no_grad():
                        return _new_state(params, enc_out, cfg, b, cache_len,
                                          False, self_quant, suppress_mask)
                st = graphs.add(key, enc_out.device, _state_nbytes(
                    params, enc_out, cfg, b, cache_len, self_quant), make)
            else:
                M.init_cache(params, enc_out, cfg, batch=b,
                             cache_len=cache_len, self_quant=self_quant,
                             out=st.cache)
                if suppress_mask is not None:
                    st.mask.copy_(suppress_mask)
                st.tokens.zero_()
            held = st is not None
        if not held:  # eager, or a state larger than the graphs may hold
            graphs = None
            st = _new_state(params, enc_out, cfg, b, cache_len, kv_quant,
                            self_quant, suppress_mask)
        # the graphs read the state's copy of the mask
        logp_fn = make_logp_fn(n_prompt, eot_id, st.mask, suppress_until_len,
                               ts_begin, max_initial_ts_idx, logits_hook)
        st.tokens[:, :n_prompt] = prompt
        logits, _ = M.decoder_step(params, st.tokens[:, :n_prompt], 0,
                                   st.cache, cfg)
        ns_prob = None
        if nospeech_id is not None:
            # raw (unsuppressed) distribution at the SOT position
            ns_prob = torch.softmax(logits[:, sot_pos].float(),
                                    -1)[:, nospeech_id]
        logp_fn(logits[:, -1], st.tokens, n_prompt, out=st.logp)
        st.length.fill_(n_prompt)
        st.done.zero_()
        st.sum_logp.zero_()
        st.pos.fill_(n_prompt)
        if n_prompt < max_len:
            _choose(st, eot_id, temperature, generator)

    # the JAX loop runs one more step whose output it never reads
    seq_len = n_prompt + 1
    while seq_len < max_len:
        with scope("whisper.decode.step"):
            with scope("whisper.decode.sync"):
                if bool(st.all_done):
                    break
            body = functools.partial(
                _step, params, cfg, st, logp_fn, seq_len, eot_id,
                temperature, generator,
                seq_len - 1 if graphs is None else st.pos)
            if graphs is None:
                body()
                how = "eager"
            else:
                how = graphs.step(st, suppress_mask is not None
                                  and seq_len <= suppress_until_len, body)
            if how == "replay":
                greedy_decode.graph_steps += 1
            else:
                greedy_decode.eager_steps += 1
                greedy_decode.graph_captures += how == "capture"
        seq_len += 1
    out = (st.tokens, st.length, st.sum_logp)
    if held:  # the state's buffers serve the next call
        out = tuple(t.clone() for t in out)
    return out if ns_prob is None else (*out, ns_prob)


def greedy_decode(
    params,
    enc_out: torch.Tensor,  # (B, Sa, d)
    prompt: torch.Tensor,  # (P,) shared prompt ids
    cfg: WhisperConfig,
    eot_id: int,
    suppress_mask: Optional[torch.Tensor] = None,
    batch: Optional[int] = None,
    max_depth: int = 224,
    suppress_until_len: int = 5,
    kv_quant: bool = False,
    self_quant: bool = False,
    ts_begin: Optional[int] = None,
    max_initial_ts_idx: int = 50,
    temperature: float = 0.0,  # 0 = argmax, > 0 = sampling
    generator: Optional[torch.Generator] = None,  # needed when T > 0
    nospeech_id: Optional[int] = None,  # also return p(<|nospeech|>) at SOT
    sot_pos: int = 0,
    logits_hook: Optional[Callable] = None,
) -> Tuple[torch.Tensor, ...]:
    """Greedy decode; returns (tokens (B, n_text_ctx) int64, lengths (B,),
    sum_logp (B,)), plus p(<|nospeech|>) at the SOT position when
    `nospeech_id` is given. Sequences end with EOT; rows that finish early
    keep emitting EOT until the last one finishes.

    `temperature > 0` draws each token from softmax(logp / T) with
    `generator` (`sample_tokens`; ValueError without one, as JAX raises
    without `rng`); `sum_logp` still adds the UNSCALED log-probs, the
    quality signal the fallback ladder thresholds (greedy.py:111-133)."""
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature > 0 requires a torch.Generator "
                         "(generator=...)")
    ctx = cfg.text_decoder_config.n_text_ctx
    prompt = prompt.to(device=enc_out.device, dtype=torch.long)
    n_prompt = prompt.shape[0]
    b = batch or enc_out.shape[0]
    cache_len = min(ctx, -(-(n_prompt + max_depth) // 128) * 128)
    max_len = min(ctx, n_prompt + max_depth)
    args = (params, enc_out, prompt, cfg, eot_id, suppress_mask, b,
            cache_len, max_len, suppress_until_len, kv_quant, self_quant,
            ts_begin, max_initial_ts_idx, temperature, generator,
            nospeech_id, sot_pos, logits_hook)
    graphs = STEP_GRAPHS
    if (eager_reason(enc_out, cfg, temperature, logits_hook, ts_begin,
                     kv_quant) is not None
            or not graphs.lock.acquire(blocking=False)):
        return _decode(None, *args)
    try:
        return _decode(graphs, *args)
    finally:
        graphs.lock.release()


greedy_decode.graph_steps = 0
greedy_decode.eager_steps = 0
greedy_decode.graph_captures = 0
