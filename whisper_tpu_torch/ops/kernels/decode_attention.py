"""Single-query attention over one layer of a layer-stacked KV cache:
Hopper kernels, their plain PyTorch version, and the wrapper that picks
between them by device.

Replaces four TPU kernels of `whisper_tpu/ops/pallas/decode_attention.py`
(entry `decode_attention_stacked`, and K8's `decode_attention`):
  K3  `_decode_attn_stacked_kernel`, the per-lane variant (kv_rep = 1);
  K3g `_decode_attn_stacked_group_kernel`, where kv row j serves the q
      rows [j*kv_rep, (j+1)*kv_rep) -- the beam lanes of one window
      against that window's one cross cache (any kv_rep >= 2);
  K3s `_decode_attn_stacked_scaled_kernel`, the int8 or packed-int4 self
      cache with one f32 scale per row for K and for V (`k_rowscale`,
      `v_rowscale`; batch-major, kv_rep = 1): scores times K's row scale
      before the mask, softmax weights times V's row scale, zero on masked
      rows;
  K8  `_decode_attn_kernel`, one query per row over ONE layer's flat
      (B, C, D) cache (entry `decode_attention`): the same `_attend`, so it
      launches the K3 kernel on the one-layer view (B, 1, C, D), layer 0.
The caches may be stored as bf16, f32, int8 or packed int4 (uint8, the
layout of `quantize.py`). An integer cache takes a bf16 or f32 query and
gives the output in the query's dtype, as the TPU kernels do; the
per-channel scales of a quantized cross cache are folded into the query
and the output by the caller (`models/whisper.py`), so K3/K3g stay
scale-free. The CUDA source, `csrc/decode_attention.cu`, has two kernels.
The split kernel runs a thread-block cluster of `splits` blocks per (head,
kv row, group of <= 8 lanes), each block staging a chunk of the rows by
TMA and scoring it, the cluster combining the softmax statistics and the
value sums through distributed shared memory in the one launch: K3g always
(`plan_splits` picks the cluster size), and K3 and K8 over a long cache,
one lane a group (`plan_lane_splits`: the greedy cross cache). The
one-block kernel runs one block per (head, lane) for K3 and K8 elsewhere
(every self cache) and for K3s always: row scales come only
with a batch-major self cache, at most 448 rows, which never splits. Its
warps each bring a contiguous chunk of the visible rows (K, V and row
scales) into shared memory in one round of copies and keep their own
softmax statistics, merged once. Both take the base pointer, strides and
layer index of the WHOLE stacked cache -- no per-layer copy is sliced out
before the launch. Its notes reckon the bytes that bound each.

Tolerance against the plain version: elementwise
|kernel - plain| <= ATOL + RTOL * |plain| with (ATOL, RTOL) = TOL[dtype of
the output]. The two compute the same f32 scores and the same
once-rounded weights round_bf16(exp(s - max) / sum) from the same global
max; only the order of the f32 sums differs (the split kernel sums the
exp-sum and the value sums per block of its cluster, then across the
blocks in rank order, so it is no longer bit-equal to the plain version,
but gives the same bits on every run; the one-block kernel adds its warps'
exp-sums each rescaled to the head's max), which can move a bf16 output
by one rounding step.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ...quantize import int_values
from ._build import check, library, refuse_grad, stream_ptr

TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (1e-5, 1e-5)}
NEG_INF = -1e30  # the TPU kernel's mask value
# storage dtype -> the kernel's code; uint8 is packed int4
STORAGE = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2, torch.uint8: 3}
_EXACT = (torch.bfloat16, torch.int8, torch.uint8)
_HD = 64
GROUP = 8  # most q lanes one K3g block holds (csrc/decode_attention.cu)
SMS = 132  # the H100's streaming multiprocessors
MAX_SPLITS = 4  # K3g clusters of 8 time slower than of 4 (PERF.md)
MIN_ROWS = 96  # fewest cache rows a K3g block is left (fewer: one block)
LANE_MIN_ROWS = 512  # fewest cache rows a per-lane cluster of 4 or 8 takes
LANE_MAX_BLOCKS = 320  # most blocks such a cluster puts in flight
LANE_PAIR_ROWS = 1200  # from here on a pair of blocks splits at any batch


def plan_splits(n_head: int, n_kv: int, kv_rep: int, c_used: int) -> int:
    """K3g's cluster size: blocks per (head, kv row, group of <= GROUP
    lanes) that split the c_used rows. The least power of two that puts
    2 * SMS blocks in flight, capped at MAX_SPLITS and at c_used / MIN_ROWS
    (timed by `tools/sweep_k3g_splits.py`, PERF.md section 6). Large-v2
    (20 heads) beam 5 over Sa = 750: 4 from one to six windows, 2 from
    seven to thirteen, 1 beyond; 1 below 192 rows, where a plain launch
    of whole rows beats a cluster's barriers."""
    blocks = n_head * n_kv * -(-kv_rep // GROUP)
    splits = 1
    while (splits < MAX_SPLITS and blocks * splits < 2 * SMS
           and c_used >= 2 * splits * MIN_ROWS):
        splits *= 2
    return splits


def plan_lane_splits(n_head: int, n_lane: int, c_used: int) -> int:
    """The per-lane cluster size (K3, K8): blocks per (head, lane)
    that split the c_used rows; 1 is the one-block kernel. From
    LANE_MIN_ROWS rows on, a cluster of 8, else of 4, while
    n_head * n_lane * splits stays within LANE_MAX_BLOCKS; past that, a
    pair from LANE_PAIR_ROWS rows on; else 1. Timed by
    `tools/sweep_k3g_splits.py` (PERF.md section 6), large-v2 (20 heads),
    ms at 1 / 2 / 4 / 8: one lane over Sa = 750 .0113 / .0110 / .0079 /
    .0075, two .0114 / .0116 / .0089 / .0085, four .0114 / .0129 /
    .0109 / .0112, eight .0127 / .0161 / .0193 / .0202; over Sa = 1500
    one lane .0191 / .0157 / .0117 / .0090, four .0205 / .0186 / .0159 /
    .0199, eight .0422 / .0300 / .0375 / .0390; below ~400 rows the one
    block wins (Sa = 300: .0061 / .0073 / .0069 / .0068). LANE_MIN_ROWS
    lies above the decoder's 448-row context, so a self cache, whose
    visible rows (pos + 1, on the device) may be far fewer than its
    c_used, never splits: at pos 60 of 448 rows the one block takes about
    half the split kernel's time. The greedy cross cache (Sa = 750)
    splits 8 ways."""
    blocks = n_head * n_lane
    if c_used >= LANE_MIN_ROWS:
        for splits in (8, 4):
            if blocks * splits <= LANE_MAX_BLOCKS:
                return splits
    return 2 if c_used >= LANE_PAIR_ROWS else 1


def _layer_view(cache, layer, batch_major):
    return cache[:, layer] if batch_major else cache[layer]  # (B, C, ...) view


def _rows(pos, b, device):
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int32).reshape(-1).expand(b)
    return torch.full((b,), int(pos), dtype=torch.int32, device=device)


def _check_scales(k_rowscale, v_rowscale, batch_major, kv_rep):
    if (k_rowscale is None) != (v_rowscale is None):
        raise ValueError("pass both k_rowscale and v_rowscale, or neither")
    if k_rowscale is not None and (not batch_major or kv_rep != 1):
        raise ValueError("row scales require batch_major and kv_rep=1")


def decode_attention_stacked_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: Union[int, torch.Tensor],
    layer: int,
    n_head: int,
    batch_major: bool = False,
    kv_rep: int = 1,
    k_rowscale: Optional[torch.Tensor] = None,
    v_rowscale: Optional[torch.Tensor] = None,
    c_used: Optional[int] = None,
) -> torch.Tensor:
    """The TPU kernels' `_attend` / `_attend_group` arithmetic in plain
    PyTorch, lane by lane: exact f32 scores of the pre-scaled query
    against the stored keys of its kv row (q row i reads kv row
    i // kv_rep), times K's row scale (K3s), rows past pos[i] masked, f32
    softmax, times V's row scale with masked rows zeroed (K3s), weights
    rounded once to bf16 when every operand is bf16 or integer (the TPU's
    exact path), f32 value sum, output in the cache dtype (the query's for
    an integer cache)."""
    _check_scales(k_rowscale, v_rowscale, batch_major, kv_rep)
    b, d = q.shape
    hd = d // n_head
    exact = all(t.dtype in _EXACT for t in (q, k_cache, v_cache))
    out_dtype = (q.dtype if k_cache.dtype in (torch.int8, torch.uint8)
                 else v_cache.dtype)
    k = int_values(_layer_view(k_cache, layer, batch_major))
    v = int_values(_layer_view(v_cache, layer, batch_major))
    bk = k.shape[0]
    if b != bk * kv_rep:
        raise ValueError(f"q batch {b} != kv batch {bk} * kv_rep {kv_rep}")
    cu = k.shape[1] if not c_used else min(int(c_used), k.shape[1])
    k, v = k[:, :cu], v[:, :cu]
    s = torch.einsum("brhe,bche->brhc",
                     q.float().reshape(bk, kv_rep, n_head, hd),
                     k.float().reshape(bk, cu, n_head, hd))
    if k_rowscale is not None:
        s = s * k_rowscale[:, layer, :cu].float()[:, None, None, :]
    hidden = (torch.arange(cu, device=q.device)
              > _rows(pos, b, q.device).long().reshape(bk, kv_rep, 1, 1))
    s = s.masked_fill(hidden, NEG_INF)
    w = torch.softmax(s, dim=-1)
    if v_rowscale is not None:
        vs = v_rowscale[:, layer, :cu].float()[:, None, None, :]
        w = w * torch.where(hidden, 0.0, vs)
    if exact:
        w = w.to(torch.bfloat16).float()
    o = torch.einsum("brhc,bche->brhe", w,
                     v.float().reshape(bk, cu, n_head, hd))
    return o.reshape(b, d).to(out_dtype)


def decode_attention_stacked(
    q: torch.Tensor,  # (B, d) single query, PRE-SCALED by hd^-0.5
    k_cache: torch.Tensor,  # (L, B, C, d), or (B, L, C, d) if batch_major
    v_cache: torch.Tensor,
    pos: Union[int, torch.Tensor],  # highest visible row: int (one for
    # every lane, a kernel argument) or (B,) i32
    layer: int,
    n_head: int,
    batch_major: bool = False,
    kv_rep: int = 1,
    k_rowscale: Optional[torch.Tensor] = None,  # (B, L, C) f32, int8/int4
    v_rowscale: Optional[torch.Tensor] = None,
    c_used: Optional[int] = None,  # read only rows [0, c_used)
    splits: Optional[int] = None,  # cluster size; None: the planners
) -> torch.Tensor:
    """Returns (B, d) in the cache dtype (the query's for an integer
    cache). CPU tensors take the plain version; CUDA tensors launch the
    Hopper kernel or raise: q bf16 with a bf16/int8/int4 cache, or f32
    with an f32/int8/int4 cache; head dim 64, unit channel stride, 16-byte
    aligned rows; row scales only with an int8 or int4 batch-major cache
    and kv_rep = 1, and then the one-block kernel, which takes a cache
    whose rows fit its shared memory and 512 rows (else ValueError; K3
    and K8 take the split kernel at splits = 1 there: a cross cache that
    `plan_lane_splits` leaves whole, or an f32 cache past ~300 rows).
    kv_rep = 1 is K3 (counted in `.launches`; those over a layer-major
    cross cache in `.cross_launches` too), kv_rep > 1 K3g
    (`.group_launches`), row scales K3s (`.scaled_launches` over an int8
    cache, `.scaled_int4_launches` over a packed-int4 one). Rows past
    c_used are never read. `splits` forces the cluster size (1 to 8;
    None: `plan_lane_splits` for kv_rep = 1, `plan_splits` above;
    `tools/sweep_k3g_splits.py` times each): it moves only the order of
    the f32 sums. Per lane, 1 is the one-block kernel."""
    _check_scales(k_rowscale, v_rowscale, batch_major, kv_rep)
    if q.device.type == "cpu":
        return decode_attention_stacked_plain(
            q, k_cache, v_cache, pos, layer, n_head, batch_major, kv_rep,
            k_rowscale, v_rowscale, c_used)
    refuse_grad("decode_attention_stacked", q, k_cache, v_cache, k_rowscale,
                v_rowscale)
    out = _launch(q, k_cache, v_cache, pos, layer, n_head, batch_major,
                  kv_rep, k_rowscale, v_rowscale, c_used, splits)
    if k_rowscale is not None and k_cache.dtype == torch.uint8:
        decode_attention_stacked.scaled_int4_launches += 1
    elif k_rowscale is not None:
        decode_attention_stacked.scaled_launches += 1
    elif kv_rep == 1:
        decode_attention_stacked.launches += 1
        decode_attention_stacked.cross_launches += not batch_major
    else:
        decode_attention_stacked.group_launches += 1
    return out


def _launch(q, k_cache, v_cache, pos, layer, n_head, batch_major, kv_rep,
            k_rowscale, v_rowscale, c_used, splits=None) -> torch.Tensor:
    """Check what the CUDA kernel takes and launch it; counts nothing."""
    b, d = q.shape
    if kv_rep < 1:
        raise ValueError(f"kv_rep {kv_rep} must be >= 1")
    sd = k_cache.dtype
    integer = sd in (torch.int8, torch.uint8)
    if (sd not in STORAGE or v_cache.dtype != sd
            or q.dtype not in (torch.bfloat16, torch.float32)
            or (not integer and q.dtype != sd)):
        raise TypeError(f"decode attention kernel takes a bf16/f32 cache with "
                        f"a query of its dtype, or an int8/int4 cache with a "
                        f"bf16/f32 query; got q {q.dtype} k {sd} "
                        f"v {v_cache.dtype}")
    scaled = k_rowscale is not None
    if scaled and not integer:
        raise TypeError(f"row scales (K3s) take an int8 or int4 cache, got "
                        f"{sd}")
    if d != n_head * _HD:
        raise ValueError(f"head dim {d // n_head} != {_HD}")
    if k_cache.shape != v_cache.shape:
        raise ValueError("k and v caches differ in shape")
    per_elem = 2 if sd == torch.uint8 else 1  # channels per stored element
    if k_cache.shape[3] * per_elem != d:
        raise ValueError(f"cache rows hold {k_cache.shape[3] * per_elem} "
                         f"channels, q has {d}")
    lane_dim, layer_dim = (0, 1) if batch_major else (1, 0)
    if k_cache.shape[lane_dim] * kv_rep != b:
        raise ValueError(f"q batch {b} != kv batch {k_cache.shape[lane_dim]}"
                         f" * kv_rep {kv_rep}")
    c = k_cache.shape[2]
    cu = c if not c_used else min(int(c_used), c)
    # each thread loads 8 channels of a row (16, 8, 4 or 32 bytes): unit
    # channel stride and 16-byte aligned rows for every storage type
    es = k_cache.element_size()
    ks, vs, qs = k_cache.stride(), v_cache.stride(), q.stride()
    if (ks[3] != 1 or vs[3] != 1 or qs[1] != 1
            or any(x * es % 16 for x in ks[:3] + vs[:3])
            or qs[0] * q.element_size() % 16
            or (q.data_ptr() | k_cache.data_ptr() | v_cache.data_ptr()) % 16):
        raise ValueError(f"q/k/v need unit channel stride and 16-byte aligned "
                         f"rows, got strides {qs} {ks} {vs}")
    sc_ptr = (0, 0)
    sc_strides = (0, 0)
    if scaled:
        shape = k_cache.shape[:3]
        if (k_rowscale.shape != shape or v_rowscale.shape != shape
                or k_rowscale.dtype != torch.float32
                or v_rowscale.dtype != torch.float32
                or k_rowscale.stride() != v_rowscale.stride()
                or k_rowscale.stride(2) != 1
                or not k_rowscale.is_cuda or not v_rowscale.is_cuda):
            raise ValueError(f"row scales must be f32 {tuple(shape)} with unit "
                             f"row stride, got {tuple(k_rowscale.shape)} "
                             f"{k_rowscale.dtype}")
        sc_ptr = (k_rowscale.data_ptr(), v_rowscale.data_ptr())
        sc_strides = k_rowscale.stride()[:2]
    if splits is None:
        splits = (1 if scaled  # K3s: the one-block kernel
                  else plan_lane_splits(n_head, b, cu) if kv_rep == 1
                  else plan_splits(n_head, b // kv_rep, kv_rep, cu))
    elif not 1 <= splits <= 8:
        raise ValueError(f"splits {splits} must be in 1..8")
    elif scaled and splits != 1:
        raise ValueError(f"splits {splits}: row scales (K3s) take the "
                         f"one-block kernel only")
    pos_all, pos_rows = 0, None
    if not isinstance(pos, torch.Tensor):
        pos_all = int(pos)  # a kernel argument: no tensor, no load of it
        if pos_all < 0:
            raise ValueError(f"pos {pos_all} must be >= 0")
    elif (pos.shape == (b,) and pos.dtype == torch.int32 and pos.is_cuda):
        pos_rows = pos
    else:  # kept alive (a local) until the launch is enqueued
        pos_rows = _rows(pos, b, q.device).contiguous()
    out = torch.empty((b, d), dtype=q.dtype, device=q.device)
    err = library().wtt_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        None if pos_rows is None else pos_rows.data_ptr(), pos_all,
        out.data_ptr(), sc_ptr[0] or None,
        sc_ptr[1] or None, b, n_head, kv_rep, splits, cu, int(layer),
        k_cache.shape[layer_dim], STORAGE[sd],
        int(q.dtype == torch.float32), qs[0], ks[lane_dim], ks[layer_dim],
        ks[2], vs[lane_dim], vs[layer_dim], vs[2], sc_strides[0],
        sc_strides[1], out.stride(0), stream_ptr(q))
    check(err, "wtt_decode_attention")
    return out


decode_attention_stacked.launches = 0
decode_attention_stacked.cross_launches = 0
decode_attention_stacked.group_launches = 0
decode_attention_stacked.scaled_launches = 0
decode_attention_stacked.scaled_int4_launches = 0


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           pos: Union[int, torch.Tensor],
                           n_head: int) -> torch.Tensor:
    """K8's arithmetic: the TPU kernel `_decode_attn_kernel` computes the
    same `_attend` as the stacked one, so this is the stacked plain version
    over the one-layer view (B, C, D) -> (B, 1, C, D), layer 0."""
    return decode_attention_stacked_plain(q, k_cache[:, None],
                                          v_cache[:, None], pos, 0, n_head,
                                          batch_major=True)


def decode_attention(
    q: torch.Tensor,  # (B, D) single query, PRE-SCALED by hd^-0.5
    k_cache: torch.Tensor,  # (B, C, D) one layer's flat cache
    v_cache: torch.Tensor,
    pos: Union[int, torch.Tensor],  # highest visible row: int or (B,) i32
    n_head: int,
) -> torch.Tensor:
    """K8, the flat single-query decode attention (the JAX
    `decode_attention`, decode_attention.py:401): returns (B, D) in v's
    dtype, or in q's for an integer (int8, packed int4) cache.

    CPU tensors take `decode_attention_plain`. CUDA tensors launch the
    K3 kernel of `csrc/decode_attention.cu` on the one-layer view
    (B, 1, C, D), layer 0, with per-row pos, or raise: the view must meet
    K3's rules (see `decode_attention_stacked`), so a cache sliced out of
    a larger buffer needs unit channel stride and 16-byte aligned rows
    and base, else ValueError. Counted in `.flat_launches`, apart from
    K3's counters."""
    if k_cache.dim() != 3 or v_cache.dim() != 3:
        raise ValueError(f"flat caches are (B, C, D), got {tuple(k_cache.shape)}"
                         f" and {tuple(v_cache.shape)}")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, pos, n_head)
    refuse_grad("decode_attention", q, k_cache, v_cache)
    out = _launch(q, k_cache[:, None], v_cache[:, None], pos, 0, n_head,
                  True, 1, None, None, None)
    decode_attention.flat_launches += 1
    return out


decode_attention.flat_launches = 0
