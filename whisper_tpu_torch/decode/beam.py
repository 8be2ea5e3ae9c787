"""Beam search over one window, with a KV cache, in PyTorch.

Counterpart of `whisper_tpu/decode/beam.py::beam_search` (reference:
whisper-burn `src/beam.rs` as driven by `src/transcribe.rs:148-383`), with
the same semantics:

  * scores are raw summed log-probs, no length normalisation;
  * each step takes a global top-K over the (K x V) candidates of the
    active beams;
  * a beam whose last token is EOT is finished: it is frozen into a
    separate top-K finished pool;
  * the search stops when the best finished beam is at least as good as
    the best active one (ties prefer the finished beam), after
    `max_depth` steps, or at the context length;
  * the suppression window, timestamp rules and logits hook of
    `greedy.py` shape each step's distribution.

The JAX search is one `lax.while_loop` on the device; here the loop runs
on the host over eager steps and reads one flag back per step (the stop
rule). The reshuffle permutes the self-KV cache by the new beams' parents
with the lane-permute kernel (`ops/kernels/permute.py`, K4) into a second
buffer pair, and the decoder step then appends to it in place; the two
pairs swap every step. Both pairs start zeroed, so rows never written stay
finite for the masked einsum path. The cross cache stays at one copy for
the window, which the decode step reads through the grouped kernel (K3g).
Quantised caches and the fused reshuffle are ROADMAP queue 1 item 9.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..config import WhisperConfig
from ..models import whisper as M
from ..ops.kernels.permute import permute_lanes_arrays
from .greedy import make_logp_fn

NEG_INF = float("-inf")


def top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis in `jax.lax.top_k`'s order: descending,
    ties to the lowest index, and distinct indices even where every value
    is -inf (`torch.topk` leaves the order of ties unspecified)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _cache_gather(self_k: torch.Tensor, self_v: torch.Tensor,
                  parents: torch.Tensor, out_k: torch.Tensor,
                  out_v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam reshuffle of the batch-major (B, L, C, d) self-KV pair into
    (out_k, out_v): `out[i] = cache[parents[i]]`, whole slabs, as the JAX
    bf16 path copies them (beam.py:248)."""
    return permute_lanes_arrays((self_k, self_v), parents, (out_k, out_v))


def _best_scores(logp, valid, eot, fin_logp):
    """(best finished score, best active score) for the stop rule."""
    fin_like = torch.where(valid & eot, logp, NEG_INF)
    best_fin = torch.maximum(fin_like.max(), fin_logp.max())
    return best_fin, torch.where(valid & ~eot, logp, NEG_INF).max()


def beam_search(
    params,
    enc_out: torch.Tensor,  # (1, Sa, d)
    prompt: torch.Tensor,  # (P,) prompt ids
    cfg: WhisperConfig,
    eot_id: int,
    suppress_mask: Optional[torch.Tensor] = None,  # (V,) f32, 0 or -inf
    beam_size: int = 5,
    max_depth: int = 100,
    suppress_until_len: int = 5,
    kv_quant: bool = False,
    self_quant: bool = False,
    ts_begin: Optional[int] = None,
    max_initial_ts_idx: int = 50,
    nospeech_id: Optional[int] = None,  # also return p(<|nospeech|>) at SOT
    sot_pos: int = 0,
    fuse_reshuffle: Optional[bool] = None,
    logits_hook: Optional[Callable] = None,
) -> Tuple[torch.Tensor, ...]:
    """Returns (tokens (n_text_ctx,) int64, length, log_prob) as 0-d
    tensors, plus p(<|nospeech|>) at the SOT position when `nospeech_id`
    is given. The sequence includes the prompt."""
    if kv_quant or self_quant or fuse_reshuffle:
        raise NotImplementedError(
            "kv_quant, self_quant and the fused reshuffle are ROADMAP queue "
            "1 item 9, not ported yet")
    k = beam_size
    dec_cfg = cfg.text_decoder_config
    v, ctx = dec_cfg.n_vocab, dec_cfg.n_text_ctx
    device = enc_out.device
    prompt = prompt.to(device=device, dtype=torch.long)
    p = prompt.shape[0]
    logp_fn = make_logp_fn(p, eot_id, suppress_mask, suppress_until_len,
                           ts_begin, max_initial_ts_idx, logits_hook)

    # prefill: all K lanes carry the prompt; only lane 0 is live
    cur_tokens = torch.zeros((k, ctx), dtype=torch.long, device=device)
    cur_tokens[:, :p] = prompt
    cache_len = min(ctx, -(-(p + max_depth) // 128) * 128)
    cache = M.init_cache(params, enc_out, cfg, batch=k, cache_len=cache_len)
    spare_k, spare_v = torch.zeros_like(cache.self_k), torch.zeros_like(
        cache.self_v)
    logits, cache = M.decoder_step(params, cur_tokens[:, :p], 0, cache, cfg)
    ns_prob = None
    if nospeech_id is not None:
        ns_prob = torch.softmax(logits[0, sot_pos].float(), -1)[nospeech_id]
    logp_next = logp_fn(logits[:, -1], cur_tokens, p)

    lane = torch.arange(k, device=device)
    cur_len = p
    cur_logp = torch.where(lane == 0, 0.0, NEG_INF)
    cur_valid = lane == 0
    cur_eot = torch.zeros(k, dtype=torch.bool, device=device)
    fin_tokens = torch.zeros((k, ctx), dtype=torch.long, device=device)
    fin_len = torch.zeros(k, dtype=torch.long, device=device)
    fin_logp = torch.full((k,), NEG_INF, device=device)

    def go_on(depth: int) -> bool:  # the JAX loop's cond; one host sync
        if depth >= max_depth or cur_len >= ctx:
            return False
        best_fin, best_active = _best_scores(cur_logp, cur_valid, cur_eot,
                                             fin_logp)
        return bool(best_fin < best_active)

    depth = 0
    go = go_on(depth)
    while go:
        # (a) fold EOT-ended beams into the finished pool
        cand_fin = torch.cat([fin_logp, torch.where(cur_valid & cur_eot,
                                                    cur_logp, NEG_INF)])
        fin_logp, fin_idx = top_k_stable(cand_fin, k)
        fin_tokens = torch.cat([fin_tokens, cur_tokens])[fin_idx]
        fin_len = torch.cat([fin_len, torch.full_like(fin_len, cur_len)])[
            fin_idx]
        # (b) expand the active beams: global top-K over (K x V)
        active = cur_valid & ~cur_eot
        cand = torch.where(active[:, None], cur_logp[:, None] + logp_next,
                           NEG_INF)
        new_logp, flat = top_k_stable(cand.reshape(-1), k)
        parent, tok = flat // v, flat % v
        cur_tokens = cur_tokens[parent]
        cur_tokens[:, cur_len] = tok
        cur_logp = new_logp
        cur_valid = new_logp > NEG_INF
        cur_eot = (tok == eot_id) & cur_valid
        pos, cur_len, depth = cur_len, cur_len + 1, depth + 1
        # the JAX loop runs one more decoder step whose output it never
        # reads; the host loop checks the stop rule first
        go = go_on(depth)
        if go:  # (c) reshuffle into the spare pair, swap, append + logits
            new_k, new_v = _cache_gather(cache.self_k, cache.self_v,
                                         parent.to(torch.int32), spare_k,
                                         spare_v)
            spare_k, spare_v = cache.self_k, cache.self_v
            cache = M.DecoderCache(new_k, new_v, cache.cross_k, cache.cross_v)
            logits, cache = M.decoder_step(params, tok[:, None], pos, cache,
                                           cfg)
            logp_next = logp_fn(logits[:, -1], cur_tokens, cur_len)

    # result: the best beam overall; ties prefer a finished one
    fin_like = torch.where(cur_valid & cur_eot, cur_logp, NEG_INF)
    best_cur = torch.argmax(fin_like)
    best_pool = torch.argmax(fin_logp)
    use_pool = fin_logp[best_pool] >= fin_like[best_cur]
    best_fin_logp = torch.where(use_pool, fin_logp[best_pool],
                                fin_like[best_cur])
    best_fin_tokens = torch.where(use_pool, fin_tokens[best_pool],
                                  cur_tokens[best_cur])
    best_fin_len = torch.where(use_pool, fin_len[best_pool], cur_len)
    active_logp = torch.where(cur_valid & ~cur_eot, cur_logp, NEG_INF)
    best_active = torch.argmax(active_logp)
    take_fin = best_fin_logp >= active_logp[best_active]
    tokens = torch.where(take_fin, best_fin_tokens, cur_tokens[best_active])
    length = torch.where(take_fin, best_fin_len, cur_len)
    logp = torch.where(take_fin, best_fin_logp, active_logp[best_active])
    if ns_prob is not None:
        return tokens, length, logp, ns_prob
    return tokens, length, logp
