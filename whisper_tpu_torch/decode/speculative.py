"""Speculative greedy decoding: a small DRAFT model proposes the next few
tokens and ONE target `decoder_step` over the whole candidate block
verifies them.

Counterpart of `whisper_tpu/decode/speculative.py::
speculative_greedy_decode`, with its signature, outputs and guards. Greedy
acceptance -- keep the longest candidate prefix whose target argmax agrees,
then take the target's own argmax at the first disagreement as a bonus
token -- makes the output TOKEN-IDENTICAL to plain `greedy_decode` at
temperature 0: every emitted token is the argmax of the TARGET's
distribution, and the draft changes only how many target steps it takes.

The JAX decode is one `lax.while_loop`; here each block is a host loop
iteration with ONE host sync, the read of (n_emit, done). The draft's k-1
steps are S = 1 steps, which take the fused path (the K3 decode-attention
kernel over its self and cross caches under attention="flash"); the
target's verify step is S = k and takes `decoder_step`'s general path
(einsum attention in f32, the W8A8 matmul kernels under
int8_impl="pallas"). On the card the two target paths round differently,
so a verify argmax can differ from plain greedy's S = 1 argmax at a near
tie; on the CPU both paths compute the same values. Rejected candidate
rows left in either cache are overwritten by later blocks, and every cache
read is bounded by the current position, so no rollback copies are
needed.

One departure from the JAX decode: on full acceptance JAX's draft never
writes the last candidate cand[k-1] into its self cache (its k-1 draft
steps write cand[0..k-2]), so row seq_len+k-1 stays zero and every later
proposal attends to that zero key and value. Here one extra S = 1 draft
step writes that row before the next block's proposals. The emitted tokens
cannot change (the target decides them); acceptance only improves. With
k = 1 the draft proposes nothing and its cache is never read after the
prefill, so no row is written.

`speculative_greedy_decode.iterations` counts verify blocks and
`.accepted` the proposals the target agreed with (before EOT and depth
truncation), so the acceptance rate over a run of one block size k is
accepted / (iterations * (k - 1)).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..config import WhisperConfig
from ..models import whisper as M
from .greedy import make_logp_fn


def speculative_greedy_decode(
    params,
    enc_out: torch.Tensor,  # (1, Sa, d) target encoder output
    prompt: torch.Tensor,  # (P,) ids
    cfg: WhisperConfig,
    eot_id: int,
    draft_params,
    draft_enc_out: torch.Tensor,  # (1, Sa_d, d_d) draft encoder output
    draft_cfg: WhisperConfig,
    suppress_mask: Optional[torch.Tensor] = None,
    n_draft: int = 4,  # block size k: 1 committed + k-1 proposals a block
    max_depth: int = 224,
    suppress_until_len: int = 5,
    kv_quant: bool = False,
    self_quant: bool = False,
    ts_begin: Optional[int] = None,
    max_initial_ts_idx: int = 50,
    nospeech_id: Optional[int] = None,
    sot_pos: int = 0,
    logits_hook: Optional[Callable] = None,
    draft_logits_hook: Optional[Callable] = None,
    *,
    caches: Optional[dict] = None,
) -> Tuple[torch.Tensor, ...]:
    """Speculative greedy decode; returns `greedy_decode`'s outputs --
    (tokens (1, n_text_ctx) int64, lengths (1,), sum_logp (1,)), plus
    p(<|nospeech|>) at `sot_pos` when `nospeech_id` is given -- with the
    same values at temperature 0.

    `kv_quant`/`self_quant` apply to the TARGET's caches; the draft's stay
    unquantized. `draft_logits_hook` (default: `logits_hook`) replaces the
    hook on the draft's proposal distributions only: it can change the
    acceptance rate, never the output. `caches`, when a dict is given,
    receives the final DecoderCaches under "target" and "draft"."""
    k = int(n_draft)
    if k < 1:
        raise ValueError("n_draft must be >= 1")
    if enc_out.shape[0] != 1:
        raise ValueError(
            "speculative decoding is B=1 only (got batch "
            f"{enc_out.shape[0]}); batched lanes accept different prefix "
            "lengths per lane, which the lockstep cache bookkeeping cannot "
            "represent")
    t_vocab = cfg.text_decoder_config.n_vocab
    d_vocab = draft_cfg.text_decoder_config.n_vocab
    if t_vocab != d_vocab:
        raise ValueError(
            f"draft vocab {d_vocab} != target vocab {t_vocab}: speculative "
            "decoding requires a shared tokenizer")
    ctx = cfg.text_decoder_config.n_text_ctx
    device = enc_out.device
    prompt = prompt.to(device=device, dtype=torch.long)
    n_prompt = prompt.shape[0]
    if n_prompt + max_depth + k > min(ctx,
                                      draft_cfg.text_decoder_config.n_text_ctx):
        raise ValueError(
            f"prompt ({n_prompt}) + max_depth ({max_depth}) + n_draft ({k}) "
            f"must fit in the decoder context ({ctx}): the verify step "
            "writes k cache rows past the current position")

    logp_fn = make_logp_fn(n_prompt, eot_id, suppress_mask,
                           suppress_until_len, ts_begin, max_initial_ts_idx,
                           logits_hook)
    draft_logp_fn = logp_fn if draft_logits_hook is None else make_logp_fn(
        n_prompt, eot_id, suppress_mask, suppress_until_len, ts_begin,
        max_initial_ts_idx, draft_logits_hook)

    tokens = torch.zeros((1, ctx), dtype=torch.long, device=device)
    tokens[:, :n_prompt] = prompt
    # +k headroom: the verify step writes candidate rows [pos, pos + k),
    # the last of which can start at max_len - 1
    cache_len = min(ctx, -(-(n_prompt + max_depth + k) // 128) * 128)
    cache_t = M.init_cache(params, enc_out, cfg, batch=1,
                           cache_len=cache_len, kv_quant=kv_quant,
                           self_quant=self_quant)
    cache_d = M.init_cache(draft_params, draft_enc_out, draft_cfg, batch=1,
                           cache_len=cache_len)
    logits, cache_t = M.decoder_step(params, tokens[:, :n_prompt], 0,
                                     cache_t, cfg)
    M.decoder_step(draft_params, tokens[:, :n_prompt], 0, cache_d, draft_cfg)
    ns_prob = None
    if nospeech_id is not None:
        ns_prob = torch.softmax(logits[:, sot_pos].float(), -1)[:, nospeech_id]
    logp_next = logp_fn(logits[:, -1], tokens, n_prompt)

    length = torch.full((1,), n_prompt, dtype=torch.long, device=device)
    sum_logp = torch.zeros((1,), dtype=torch.float32, device=device)
    idx = torch.arange(k, device=device)
    seq_len = n_prompt
    max_len = min(ctx, n_prompt + max_depth)
    while seq_len < max_len:
        # the committed token for position seq_len: fully determined by
        # the previous block's distribution (first index on ties, as jnp)
        t0 = torch.argmax(logp_next, dim=-1)
        cand = torch.zeros((1, k), dtype=torch.long, device=device)
        cand[:, 0] = t0
        # draft phase: k-1 proposals. Each step writes the current token
        # into the hypothesis buffer first, then applies the rules at the
        # advanced length -- the order of the plain greedy loop.
        hyp = tokens.clone()
        cur = t0
        for j in range(k - 1):
            pos = seq_len + j
            hyp[:, pos] = cur
            logits_d, _ = M.decoder_step(draft_params, cur[:, None], pos,
                                         cache_d, draft_cfg)
            cur = torch.argmax(draft_logp_fn(logits_d[:, -1], hyp, pos + 1),
                               dim=-1)
            cand[:, j + 1] = cur
        # the last proposal enters the hypothesis buffer too: the verify's
        # final position applies the rules with it as the last token
        hyp[:, seq_len + k - 1] = cand[:, k - 1]

        # verify: one target step over the candidate block; logits_t[:, i]
        # is the distribution for position seq_len + i + 1
        logits_t, _ = M.decoder_step(params, cand, seq_len, cache_t, cfg)
        lp_stack = torch.stack([logp_fn(logits_t[:, i], hyp, seq_len + i + 1)
                                for i in range(k)])  # (k, 1, V)
        g = torch.argmax(lp_stack, dim=-1)  # (k, 1)

        # acceptance: the longest agreeing prefix, cut after the first
        # emitted EOT (greedy stops there) and at max_len
        if k > 1:
            match = (g[:-1, 0] == cand[0, 1:]).long()
            n_acc = torch.cumprod(match, 0).sum()
        else:
            n_acc = torch.zeros((), dtype=torch.long, device=device)
        n_emit = 1 + n_acc
        eot_pos = torch.where((cand[0] == eot_id) & (idx < n_emit), idx, k)
        first_eot = eot_pos.min()
        n_emit = torch.clamp(torch.minimum(n_emit, first_eot + 1),
                             max=max_len - seq_len)
        n_acc_h, n_emit_h, done = torch.stack(
            (n_acc, n_emit, (first_eot < n_emit).long())).tolist()
        speculative_greedy_decode.iterations += 1
        speculative_greedy_decode.accepted += n_acc_h

        tokens[:, seq_len:seq_len + n_emit_h] = cand[:, :n_emit_h]
        # each token's log-prob comes from the target distribution that
        # predicted it
        lp_prev = torch.cat((logp_next[None], lp_stack[:-1]))  # (k, 1, V)
        tok_lp = lp_prev[:, 0, :].gather(1, cand[0, :, None])[:, 0]
        sum_logp = sum_logp + torch.where(idx < n_emit, tok_lp, 0.0).sum()
        length = length + n_emit_h
        # the distribution for the next position, produced by the last
        # accepted candidate: what plain greedy computes there
        logp_next = lp_stack[n_emit_h - 1]
        seq_len += n_emit_h
        if done:
            break
        if n_emit_h == k > 1 and seq_len < max_len:
            # full acceptance: the draft has not seen cand[k-1] yet; write
            # its row before the next block's proposals read it
            M.decoder_step(draft_params, cand[:, k - 1:], seq_len - 1,
                           cache_d, draft_cfg)
    if caches is not None:
        caches["target"], caches["draft"] = cache_t, cache_d
    if ns_prob is not None:
        return tokens, length, sum_logp, ns_prob
    return tokens, length, sum_logp


speculative_greedy_decode.iterations = 0
speculative_greedy_decode.accepted = 0
