"""Beam search with a KV cache, in PyTorch: one loop over W windows of K
lanes each (`beam_search_batched`); `beam_search` is its W = 1 case.

Counterpart of `whisper_tpu/decode/beam.py::beam_search` and
`beam_search_batched` (reference: whisper-burn `src/beam.rs` as driven by
`src/transcribe.rs:148-383`), with the same semantics per window:

  * scores are raw summed log-probs, no length normalisation;
  * each step takes the top-K over the (K x V) candidates of the window's
    active beams, found exactly as the top-K over the (K x K) proposals
    of each lane's own top-K;
  * a beam whose last token is EOT is finished: it is frozen into a
    separate top-K finished pool;
  * a window stops when its best finished beam is at least as good as its
    best active one (ties prefer the finished beam); the loop ends when
    every window has stopped, after `max_depth` steps, or at the context
    length;
  * the suppression window, timestamp rules and logits hook of
    `greedy.py::make_masked_logits_fn` shape each step's distribution.

The JAX search is one `lax.while_loop` on the device; here the loop runs
on the host over eager steps and reads one flag back per step (the stop
rule). The cross cache stays at one copy per window (bf16, or int8 /
int4 with `kv_quant`), which the decode step reads through the grouped
kernel (K3g). The self-KV reshuffle by the new beams' parents takes one of
two routes, as in JAX:
  * fused (the flash config over an int8 or int4 self cache,
    `self_quant`; JAX's default knobs fused_permute=True and cow=True, so
    copy-on-write rides every fused reshuffle, beam.py:179): the decode
    step's fused kernel (K5) reads each lane's parent slab, appends, attends and writes
    back in place, with copy-on-write slots from `_cow_assign` -- the
    cache lives in PHYSICAL slot order and `phys` maps each logical lane
    to its slot;
  * separate (bf16 caches, the "xla" config, or `fuse_reshuffle=False`):
    the lane-permute kernel (`ops/kernels/permute.py`, K4) copies the
    caches into a second buffer pair (a quantized cache with its row
    scales, only the valid row prefix), the decoder step appends in place, and
    the pairs swap every step. Both pairs start zeroed (scales at one), so
    rows never written stay finite for the masked einsum path.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import WhisperConfig
from ..models import whisper as M
from ..ops.kernels.permute import permute_lanes_arrays
from ..quantize import QTensor
from ..utils.profiling import scope
from .greedy import make_masked_logits_fn

NEG_INF = float("-inf")


def top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis in `jax.lax.top_k`'s order: descending,
    ties to the lowest index, and distinct indices even where every value
    is -inf (`torch.topk` leaves the order of ties unspecified)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _top_k_iter(x: torch.Tensor, k: int):
    """Top-k over the last axis by k argmax passes (beam.py:42): ties to
    the lowest index; a row with fewer than k finite entries repeats index
    0 for its -inf tail (JAX's duplicate-0 quirk, kept for parity)."""
    vals, idxs = [], []
    iota = torch.arange(x.shape[-1], device=x.device)
    for _ in range(k):
        i = torch.argmax(x, dim=-1)  # the first maximum, as jnp.argmax
        vals.append(torch.gather(x, -1, i[..., None])[..., 0])
        idxs.append(i)
        x = torch.where(iota == i[..., None], NEG_INF, x)
    return torch.stack(vals, -1), torch.stack(idxs, -1)


def _segments(x: torch.Tensor, seg: int):
    """x (..., n) padded with -inf to whole segments -> (..., nseg, seg)."""
    pad = (-x.shape[-1]) % seg
    if pad:
        x = F.pad(x, (0, pad), value=NEG_INF)
    return x.reshape(*x.shape[:-1], -1, seg)


def _top_k_segments(xs: torch.Tensor, seg_max: torch.Tensor, k: int):
    """The second level of `_top_k` (beam.py:94-108): the top-k segments by
    their maxima (distinct indices, `lax.top_k`'s order), re-sorted
    ascending so that gathered position order is global index order, then
    `_top_k_iter` over their k * seg candidates."""
    seg = xs.shape[-1]
    seg_idx = torch.sort(top_k_stable(seg_max, k)[1], dim=-1).values
    gathered = torch.gather(
        xs, -2, seg_idx[..., None].expand(*seg_idx.shape, seg))
    vals, local = _top_k_iter(gathered.reshape(*xs.shape[:-2], k * seg), k)
    gi = torch.gather(seg_idx, -1, local // seg) * seg + local % seg
    return vals, torch.where(torch.isneginf(vals), 0, gi)


def _top_k(x: torch.Tensor, k: int, seg: int = 128):
    """Exact top-k, two-level (beam.py:68): segment maxima, the top-k
    segments, then the top-k of their candidates; element-identical to
    `_top_k_iter`, ties and the -inf duplicate-0 quirk included."""
    if x.shape[-1] <= 4 * seg:
        return _top_k_iter(x, k)
    xs = _segments(x, seg)
    return _top_k_segments(xs, xs.amax(dim=-1), k)


def _topk_lse(x: torch.Tensor, k: int, seg: int = 128):
    """Per-row top-k (as `_top_k`) and logsumexp from the same per-segment
    maxima (beam.py:111): lse = log(sum_j exp(m_j - M) * sum_seg_j exp(x -
    m_j)) + M; -inf segments add 0 and an all--inf row gives -inf."""
    if x.shape[-1] <= 4 * seg:
        vals, idx = _top_k_iter(x, k)
        return vals, idx, torch.logsumexp(x, dim=-1)
    xs = _segments(x, seg)
    seg_max = xs.amax(dim=-1)
    safe = torch.where(torch.isneginf(seg_max), 0.0, seg_max)
    seg_sum = torch.exp(xs - safe[..., None]).sum(dim=-1)
    m = seg_max.amax(dim=-1)
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    total = (seg_sum * torch.exp(seg_max - m_safe[..., None])).sum(dim=-1)
    lse = torch.where(torch.isneginf(m), NEG_INF, torch.log(total) + m)
    vals, gi = _top_k_segments(xs, seg_max, k)
    return vals, gi, lse


def _fuse_reshuffle(self_k, cfg: WhisperConfig, allow=None) -> bool:
    """True when the reshuffle rides the fused decode kernel (K5): the
    flash config over a quantized (QTensor: int8 or packed int4) self
    cache, unless the caller passes `allow=False` (beam.py:160, with the
    JAX knob default fused_permute=True)."""
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
    caches copy whole slabs; quantized (int8 or packed int4) QTensor
    caches permute their q (as bytes) and row-scale arrays in the same K4
    launch and, given `valid_len`, copy only the row prefix [0, ceil(valid_len / 32) * 32) of q (the scales
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
    """Beam search over one window, JAX's `beam_search`: returns (tokens
    (n_text_ctx,) int64, length, log_prob) as 0-d tensors, plus
    p(<|nospeech|>) at the SOT position when `nospeech_id` is given. The
    sequence includes the prompt. `kv_quant` / `self_quant` pick the cache
    types (`models/whisper.py::init_cache`); `fuse_reshuffle=False` keeps a
    quantized self cache off the fused kernel (module doc).

    It runs `beam_search_batched` at W = 1: the same tokens and length as
    JAX's global top-K over (K x V); log_prob sums each step's x - lse
    where JAX sums a log-softmax, so it may differ in the last bits."""
    out = beam_search_batched(
        params, enc_out, prompt, cfg, eot_id, suppress_mask, beam_size,
        max_depth, suppress_until_len, kv_quant, self_quant, nospeech_id,
        sot_pos, fuse_reshuffle, ts_begin, max_initial_ts_idx, logits_hook)
    return tuple(x[0] for x in out)


def _window_stopped(logp, valid, eot, fin_logp) -> torch.Tensor:
    """(W,) per-window stop rule (beam.py:767): best finished >= best
    active, ties to the finished beam."""
    fin_like = torch.where(valid & eot, logp, NEG_INF)
    best_fin = torch.maximum(fin_like.amax(1), fin_logp.amax(1))
    return best_fin >= torch.where(valid & ~eot, logp, NEG_INF).amax(1)


def _pick(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t (W, K, ...) at lane idx[w] of each window -> (W, ...)."""
    i = idx.reshape(-1, 1, *([1] * (t.dim() - 2)))
    return torch.gather(t, 1, i.expand(-1, 1, *t.shape[2:]))[:, 0]


def beam_search_batched(
    params,
    enc_out: torch.Tensor,  # (W, Sa, d): W independent windows
    prompt: torch.Tensor,  # (P,) prompt ids, shared by the windows
    cfg: WhisperConfig,
    eot_id: int,
    suppress_mask: Optional[torch.Tensor] = None,  # (V,) f32, 0 or -inf
    beam_size: int = 5,
    max_depth: int = 100,
    suppress_until_len: int = 5,
    kv_quant: bool = False,
    self_quant: bool = False,
    nospeech_id: Optional[int] = None,  # also return p(<|nospeech|>) (W,)
    sot_pos: int = 0,
    fuse_reshuffle: Optional[bool] = None,
    ts_begin: Optional[int] = None,
    max_initial_ts_idx: int = 50,
    logits_hook: Optional[Callable] = None,
) -> Tuple[torch.Tensor, ...]:
    """Beam search over W windows as ONE loop over W x K flat lanes
    (beam.py:654), with the single-window semantics per window.

    Each step streams the (W*K, V) logits once (`_topk_lse`) into every
    lane's top-K proposals and their normalized log-probs; the per-window
    top-K over the (K x K) proposals is exact-equivalent to the top-K over
    the (K x V) candidates. A window whose stop rule has fired is frozen by
    masking its result-bearing state; the batch runs until every window
    has stopped, `max_depth` steps, or the context length. The cross cache
    holds one copy per window (lane i reads window i // K); the self cache
    reshuffles by one of the module doc's routes (K5 with copy-on-write
    slots over a quantized self cache on the flash config, else K4 into a
    spare pair).
    One host sync per step reads the stop rule; the decoder step whose
    output JAX computes and never reads after the last expansion is
    skipped.

    Returns (tokens (W, n_text_ctx) int64, lengths (W,), log_probs (W,)),
    plus p(<|nospeech|>) per window when `nospeech_id` is given."""
    k = beam_size
    dec_cfg = cfg.text_decoder_config
    ctx = dec_cfg.n_text_ctx
    device = enc_out.device
    prompt = prompt.to(device=device, dtype=torch.long)
    p = prompt.shape[0]
    w = enc_out.shape[0]
    b = w * k

    masked = make_masked_logits_fn(p, eot_id, suppress_mask,
                                   suppress_until_len, ts_begin,
                                   max_initial_ts_idx, logits_hook)

    def proposals(logits, tokens_flat, seq_len: int):
        """Masked (B, V) logits -> each lane's top-K (normalized log-prob,
        token id), (W, K, K) each (beam.py:704)."""
        vals, idx, lse = _topk_lse(masked(logits, tokens_flat, seq_len), k)
        return (vals - lse[:, None]).reshape(w, k, k), idx.reshape(w, k, k)

    tokens0 = torch.zeros((b, ctx), dtype=torch.long, device=device)
    tokens0[:, :p] = prompt
    cache_len = min(ctx, -(-(p + max_depth) // 128) * 128)

    def stop_rule():  # the JAX loop's cond; the one host sync of a step
        stopped = _window_stopped(cur_logp, cur_valid, cur_eot, fin_logp)
        if depth >= max_depth or cur_len >= ctx:
            return False, stopped
        with scope("whisper.decode.sync"):
            return not bool(stopped.all()), stopped

    with scope("whisper.decode.prefill"):
        cache = M.init_cache(params, enc_out, cfg, batch=b,
                             cache_len=cache_len, kv_quant=kv_quant,
                             self_quant=self_quant)
        fused = _fuse_reshuffle(cache.self_k, cfg, fuse_reshuffle)
        if not fused:
            spare_k, spare_v = _spare(cache.self_k), _spare(cache.self_v)
        logits, cache = M.decoder_step(params, tokens0[:, :p], 0, cache,
                                       cfg)
        ns_prob = None
        if nospeech_id is not None:  # lanes share the prompt: lane 0
            ns_prob = torch.softmax(logits[::k, sot_pos].float(),
                                    -1)[:, nospeech_id]
        next_vals, next_idx = proposals(logits[:, -1], tokens0, p)

        lane = torch.arange(k, device=device)
        offs = (torch.arange(w, device=device) * k)[:, None]
        phys = lane.repeat(w, 1)  # (W, K) slot of each logical lane (COW)
        cur_tokens = tokens0.reshape(w, k, ctx)
        cur_len = p
        cur_len_w = torch.full((w,), p, dtype=torch.long, device=device)
        cur_logp = torch.where(lane == 0, 0.0, NEG_INF).repeat(w, 1)
        cur_valid = (lane == 0).repeat(w, 1)
        cur_eot = torch.zeros((w, k), dtype=torch.bool, device=device)
        fin_tokens = torch.zeros((w, k, ctx), dtype=torch.long,
                                 device=device)
        fin_len = torch.zeros((w, k), dtype=torch.long, device=device)
        fin_logp = torch.full((w, k), NEG_INF, device=device)
        depth = 0
        go, stopped = stop_rule()
    while go:
        with scope("whisper.decode.step"):
            f1, f2 = stopped[:, None], stopped[:, None, None]
            # (a) fold EOT-ended beams into each window's finished pool
            cand_fin = torch.cat([fin_logp, torch.where(cur_valid & cur_eot,
                                                        cur_logp, NEG_INF)], 1)
            new_fin_logp, fin_idx = _top_k(cand_fin, k)
            all_tokens = torch.cat([fin_tokens, cur_tokens], 1)
            new_fin_tokens = torch.gather(
                all_tokens, 1, fin_idx[:, :, None].expand(-1, -1, ctx))
            all_len = torch.cat([fin_len, torch.full_like(fin_len, cur_len)],
                                1)
            new_fin_len = torch.gather(all_len, 1, fin_idx)
            # (b) expand: per-window top-K over the (K x K) proposals
            active = cur_valid & ~cur_eot
            cand = torch.where(active[:, :, None], cur_logp[:, :, None]
                               + next_vals, NEG_INF)
            new_logp, flat_idx = _top_k(cand.reshape(w, k * k), k)
            parent = flat_idx // k  # in-window parent lane
            tok = torch.gather(next_idx.reshape(w, k * k), 1, flat_idx)
            new_tokens = torch.gather(cur_tokens, 1,
                                      parent[:, :, None].expand(-1, -1, ctx))
            new_tokens[:, :, cur_len] = tok
            new_valid = new_logp > NEG_INF
            new_eot = (tok == eot_id) & new_valid
            # freeze the result-bearing state of stopped windows
            cur_tokens = torch.where(f2, cur_tokens, new_tokens)
            cur_len_w = torch.where(stopped, cur_len_w, cur_len + 1)
            cur_logp = torch.where(f1, cur_logp, new_logp)
            cur_valid = torch.where(f1, cur_valid, new_valid)
            cur_eot = torch.where(f1, cur_eot, new_eot)
            fin_tokens = torch.where(f2, fin_tokens, new_fin_tokens)
            fin_len = torch.where(f1, fin_len, new_fin_len)
            fin_logp = torch.where(f1, fin_logp, new_fin_logp)
            pos, cur_len, depth = cur_len, cur_len + 1, depth + 1
            go, stopped = stop_rule()
            if not go:
                break
            # (c) reshuffle + append + logits (stopped windows ride along on
            # their stale proposals; their results are frozen above)
            if fused:  # K5, copy-on-write slots
                src, dest = _cow_assign(parent, phys)
                logits, cache = M.decoder_step(
                    params, tok.reshape(b, 1), pos, cache, cfg,
                    parents=(src + offs).reshape(b),
                    dests=(dest + offs).reshape(b))
                phys = dest
            else:  # K4 into the spare pair, swap
                gparent = (parent + offs).reshape(b).to(torch.int32)
                new_k, new_v = _cache_gather(cache.self_k, cache.self_v,
                                             gparent, spare_k, spare_v,
                                             valid_len=pos)
                spare_k, spare_v = cache.self_k, cache.self_v
                cache = M.DecoderCache(new_k, new_v, cache.cross_k,
                                       cache.cross_v)
                logits, cache = M.decoder_step(params, tok.reshape(b, 1), pos,
                                               cache, cfg)
            next_vals, next_idx = proposals(
                logits[:, -1], new_tokens.reshape(b, ctx), cur_len)

    # per-window result: the best beam overall, ties to a finished one
    fin_like = torch.where(cur_valid & cur_eot, cur_logp, NEG_INF)
    best_fin_cur = torch.argmax(fin_like, 1)
    best_fin_pool = torch.argmax(fin_logp, 1)
    pool_logp = _pick(fin_logp, best_fin_pool)
    cur_fin_logp = _pick(fin_like, best_fin_cur)
    use_pool = pool_logp >= cur_fin_logp
    best_fin_logp = torch.where(use_pool, pool_logp, cur_fin_logp)
    best_fin_tokens = torch.where(use_pool[:, None],
                                  _pick(fin_tokens, best_fin_pool),
                                  _pick(cur_tokens, best_fin_cur))
    best_fin_len = torch.where(use_pool, _pick(fin_len, best_fin_pool),
                               cur_len_w)
    active_logp = torch.where(cur_valid & ~cur_eot, cur_logp, NEG_INF)
    best_active = torch.argmax(active_logp, 1)
    act_logp = _pick(active_logp, best_active)
    take_fin = best_fin_logp >= act_logp
    tokens = torch.where(take_fin[:, None], best_fin_tokens,
                         _pick(cur_tokens, best_active))
    length = torch.where(take_fin, best_fin_len, cur_len_w)
    logp = torch.where(take_fin, best_fin_logp, act_logp)
    if ns_prob is not None:
        return tokens, length, logp, ns_prob
    return tokens, length, logp
