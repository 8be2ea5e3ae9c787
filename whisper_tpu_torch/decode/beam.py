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
rule). The cross cache stays at one copy for the window (bf16, or int8 /
int4 with `kv_quant`), which the decode step reads through the grouped
kernel (K3g). The self-KV reshuffle by the new beams' parents takes one of
two routes, as in JAX:
  * fused (the flash config over an int8 self cache, `self_quant`; JAX's
    default knobs fused_permute=True and cow=True, so copy-on-write rides
    every fused reshuffle, beam.py:179): the decode step's fused
    kernel (K5) reads each lane's parent slab, appends, attends and writes
    back in place, with copy-on-write slots from `_cow_assign` -- the
    cache lives in PHYSICAL slot order and `phys` maps each logical lane
    to its slot;
  * separate (bf16 caches, the "xla" config, or `fuse_reshuffle=False`):
    the lane-permute kernel (`ops/kernels/permute.py`, K4) copies the
    caches into a second buffer pair (an int8 cache with its row scales,
    only the valid row prefix), the decoder step appends in place, and
    the pairs swap every step. Both pairs start zeroed (scales at one), so
    rows never written stay finite for the masked einsum path.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..config import WhisperConfig
from ..models import whisper as M
from ..ops.kernels.permute import permute_lanes_arrays
from ..quantize import QTensor
from .greedy import make_logp_fn

NEG_INF = float("-inf")


def top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis in `jax.lax.top_k`'s order: descending,
    ties to the lowest index, and distinct indices even where every value
    is -inf (`torch.topk` leaves the order of ties unspecified)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _fuse_reshuffle(self_k, cfg: WhisperConfig, allow=None) -> bool:
    """True when the reshuffle rides the fused decode kernel (K5): the
    flash config over an int8 (QTensor) self cache, unless the caller
    passes `allow=False` (beam.py:160, with the JAX knob default
    fused_permute=True)."""
    if allow is False:
        return False
    return cfg.attention == "flash" and isinstance(self_k, QTensor)


def _cow_assign(parent: torch.Tensor, phys: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Copy-on-write physical-slot assignment (beam.py:188). parent, phys:
    (W, K) in-window indices; phys[w, i] is the slot holding logical lane
    i's slab. Returns (src, dest), (W, K): new lane i reads slot
    src[i] = phys[parent[i]] and lives at slot dest[i] afterwards (the next
    step's phys). The first claimant (lowest lane) of each source slot
    stays there (dest == src); later claimants take the slots no lane reads
    this step, lowest free slot to lowest mover lane."""
    k = parent.shape[1]
    src = torch.gather(phys.long(), 1, parent.long())
    same = src[:, :, None] == src[:, None, :]  # [w, i, j]: src_i == src_j
    before = torch.ones((k, k), dtype=torch.bool,
                        device=src.device).tril(-1)  # j < i
    first = ~(same & before).any(dim=2)
    taken = (src[:, :, None] == torch.arange(k, device=src.device)).any(1)
    free_slots = torch.sort(taken.to(torch.int8), dim=1, stable=True)[1]
    mover_rank = torch.cumsum((~first).long(), dim=1) - 1
    moved_to = torch.gather(free_slots, 1, mover_rank.clamp(0, k - 1))
    return src, torch.where(first, src, moved_to)


def _cache_gather(self_k, self_v, parents: torch.Tensor, out_k, out_v,
                  valid_len: Optional[int] = None):
    """Beam reshuffle of the batch-major (B, L, C, d) self-KV pair into
    (out_k, out_v): `out[i] = cache[parents[i]]` (beam.py:226-248). bf16
    caches copy whole slabs; int8 QTensor caches permute their q and
    row-scale arrays in the same K4 launch and, given `valid_len`, copy
    only the row prefix [0, ceil(valid_len / 32) * 32) of q (the scales
    whole; a cache whose length is not a multiple of 32 copies
    everything)."""
    if isinstance(self_k, QTensor):
        if self_k.q.shape[2] % 32:
            valid_len = None
        permute_lanes_arrays(
            (self_k.q, self_k.scale, self_v.q, self_v.scale), parents,
            (out_k.q, out_k.scale, out_v.q, out_v.scale), valid_len=valid_len)
        return out_k, out_v
    return permute_lanes_arrays((self_k, self_v), parents, (out_k, out_v))


def _spare(t):
    """A second buffer like a self cache: zeros, row scales at one."""
    if isinstance(t, QTensor):
        return QTensor(torch.zeros_like(t.q), torch.ones_like(t.scale))
    return torch.zeros_like(t)


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
    is given. The sequence includes the prompt. `kv_quant` / `self_quant`
    pick the cache types (`models/whisper.py::init_cache`);
    `fuse_reshuffle=False` keeps an int8 self cache off the fused kernel
    (module doc)."""
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
    cache = M.init_cache(params, enc_out, cfg, batch=k, cache_len=cache_len,
                         kv_quant=kv_quant, self_quant=self_quant)
    fused = _fuse_reshuffle(cache.self_k, cfg, fuse_reshuffle)
    if not fused:
        spare_k, spare_v = _spare(cache.self_k), _spare(cache.self_v)
    logits, cache = M.decoder_step(params, cur_tokens[:, :p], 0, cache, cfg)
    ns_prob = None
    if nospeech_id is not None:
        ns_prob = torch.softmax(logits[0, sot_pos].float(), -1)[nospeech_id]
    logp_next = logp_fn(logits[:, -1], cur_tokens, p)

    lane = torch.arange(k, device=device)
    phys = lane.clone()  # slot of each logical lane's slab (COW)
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
        if go and fused:  # (c) fused reshuffle + append + logits, COW slots
            src, dest = _cow_assign(parent[None], phys[None])
            logits, cache = M.decoder_step(params, tok[:, None], pos, cache,
                                           cfg, parents=src[0], dests=dest[0])
            phys = dest[0]
        elif go:  # (c) reshuffle into the spare pair, swap, append + logits
            new_k, new_v = _cache_gather(cache.self_k, cache.self_v,
                                         parent.to(torch.int32), spare_k,
                                         spare_v, valid_len=pos)
            spare_k, spare_v = cache.self_k, cache.self_v
            cache = M.DecoderCache(new_k, new_v, cache.cross_k, cache.cross_v)
            logits, cache = M.decoder_step(params, tok[:, None], pos, cache,
                                           cfg)
        if go:
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
