"""Batched greedy decoding with a KV cache, in PyTorch.

Counterpart of `whisper_tpu/decode/greedy.py::greedy_decode` (and the
helpers it takes from `decode/beam.py`): the special-token suppression
window (mask while seq len <= 5, src/transcribe.rs:271-275), the
timestamp rules, a custom logits hook, and per-row EOT stops -- finished
rows keep emitting EOT and the loop ends when every row is done or at
`max_len`. The JAX loop is an on-device `lax.while_loop`; here it is a
Python loop over eager steps that reads the `done` flags back each step.
With temperature > 0 each token is drawn from softmax(logp / T) through an
explicit `torch.Generator` (`sample_tokens`), the sampling rung of the
fallback ladder (pipeline/transcribe.py).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..config import WhisperConfig
from ..models import whisper as M
from ..parallel import context as pctx
from ..utils.profiling import scope

NEG_INF = float("-inf")


def _masked_log_softmax(logits: torch.Tensor, seq_len: int,
                        suppress_mask: Optional[torch.Tensor],
                        suppress_until_len: int) -> torch.Tensor:
    """Special-token maskout while seq_len <= suppress_until_len, then an
    f32 log-softmax (src/transcribe.rs:271-276)."""
    x = logits.float()
    if suppress_mask is not None and seq_len <= suppress_until_len:
        x = x + suppress_mask
    return torch.log_softmax(x, dim=-1)


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


def make_logp_fn(prompt_len: int, eot_id: int,
                 suppress_mask: Optional[torch.Tensor],
                 suppress_until_len: int, ts_begin: Optional[int],
                 max_initial_ts_idx: int, logits_hook: Optional[Callable]):
    """The token-selection distribution `(logits (B, V), tokens (B, ctx),
    seq_len) -> logp (B, V)`: suppression window, timestamp rules, the
    custom hook (after both, before the log-softmax), f32 log-softmax."""

    def _logp(logits, tokens, seq_len: int):
        x = logits.float()
        if suppress_mask is not None and seq_len <= suppress_until_len:
            x = x + suppress_mask
        if ts_begin is not None:
            x = apply_timestamp_rules(x, tokens, seq_len, prompt_len,
                                      ts_begin, eot_id, max_initial_ts_idx)
        if logits_hook is not None:
            x = logits_hook(x, tokens, seq_len)
        return torch.log_softmax(x, dim=-1)

    return _logp


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
    dec_cfg = cfg.text_decoder_config
    ctx = dec_cfg.n_text_ctx
    device = enc_out.device
    prompt = prompt.to(device=device, dtype=torch.long)
    n_prompt = prompt.shape[0]
    b = batch or enc_out.shape[0]
    logp_fn = make_logp_fn(n_prompt, eot_id, suppress_mask,
                           suppress_until_len, ts_begin, max_initial_ts_idx,
                           logits_hook)

    tokens = torch.zeros((b, ctx), dtype=torch.long, device=device)
    tokens[:, :n_prompt] = prompt
    cache_len = min(ctx, -(-(n_prompt + max_depth) // 128) * 128)
    with scope("whisper.decode.prefill"):
        cache = M.init_cache(params, enc_out, cfg, batch=b,
                             cache_len=cache_len, kv_quant=kv_quant,
                             self_quant=self_quant)
        logits, cache = M.decoder_step(params, tokens[:, :n_prompt], 0,
                                       cache, cfg)
        ns_prob = None
        if nospeech_id is not None:
            # raw (unsuppressed) distribution at the SOT position
            ns_prob = torch.softmax(logits[:, sot_pos].float(),
                                    -1)[:, nospeech_id]
        logp_next = logp_fn(logits[:, -1], tokens, n_prompt)

    length = torch.full((b,), n_prompt, dtype=torch.long, device=device)
    done = torch.zeros((b,), dtype=torch.bool, device=device)
    sum_logp = torch.zeros((b,), dtype=torch.float32, device=device)
    seq_len = n_prompt
    max_len = min(ctx, n_prompt + max_depth)
    while seq_len < max_len:
        with scope("whisper.decode.step"):
            if temperature > 0.0:
                tok = sample_tokens(logp_next, temperature, generator)
            else:  # first index on ties, as jnp
                tok = torch.argmax(logp_next, dim=-1)
            tok_logp = logp_next.gather(1, tok[:, None])[:, 0]
            tok = torch.where(done, torch.full_like(tok, eot_id), tok)
            tokens[:, seq_len] = tok
            length = torch.where(done, length, length + 1)
            sum_logp = torch.where(done, sum_logp, sum_logp + tok_logp)
            done = done | (tok == eot_id)
            seq_len += 1
            # the JAX loop runs one more step whose output it never reads
            if seq_len >= max_len:
                break
            with scope("whisper.decode.sync"):
                if bool(done.all()):
                    break
            logits, cache = M.decoder_step(params, tok[:, None], seq_len - 1,
                                           cache, cfg)
            logp_next = logp_fn(logits[:, -1], tokens, seq_len)
    if ns_prob is not None:
        return tokens, length, sum_logp, ns_prob
    return tokens, length, sum_logp
