"""Single-query attention over one layer of a layer-stacked KV cache:
Hopper kernels, their plain PyTorch version, and the wrapper that picks
between them by device.

Replaces two TPU kernels of `whisper_tpu/ops/pallas/decode_attention.py`
(entry `decode_attention_stacked`):
  K3  `_decode_attn_stacked_kernel`, the bf16/f32 per-lane variant
      (kv_rep = 1);
  K3g `_decode_attn_stacked_group_kernel`, where kv row j serves the q
      rows [j*kv_rep, (j+1)*kv_rep) -- the beam lanes of one window
      against that window's one cross cache (kv_rep = 2 .. MAX_REP).
The CUDA source, `csrc/decode_attention.cu`, runs one block per (head,
lane) for K3 and one per (head, kv row) for K3g, and takes the base
pointer, strides and layer index of the WHOLE stacked cache -- no
per-layer copy is sliced out before the launch. Its notes reckon the
bytes that bound each.

The int8 per-row-scale variant (`_decode_attn_stacked_scaled_kernel`,
`k_rowscale`, K3s) is not ported yet (ROADMAP queue 2) and raises
NotImplementedError here.

Tolerance against the plain version: elementwise
|kernel - plain| <= ATOL + RTOL * |plain| with (ATOL, RTOL) = TOL[dtype].
The two compute the same f32 scores and the same once-rounded weights;
only the f32 summation order differs, which can move the bf16 output by
one rounding step.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ._build import check, library, stream_ptr

TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (1e-5, 1e-5)}
NEG_INF = -1e30  # the TPU kernel's mask value
MAX_REP = 8  # the largest kv_rep the grouped kernel is instantiated for
_HD = 64


def _unsupported(k_rowscale, v_rowscale):
    if k_rowscale is not None or v_rowscale is not None:
        raise NotImplementedError(
            "int8 self-KV row scales are ROADMAP queue 2 K3s, not ported yet")


def _layer_view(cache, layer, batch_major):
    return cache[:, layer] if batch_major else cache[layer]  # (B, C, d) view


def _rows(pos, b, device):
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int32).reshape(-1).expand(b)
    return torch.full((b,), int(pos), dtype=torch.int32, device=device)


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
    i // kv_rep), rows past pos[i] masked, f32 softmax, weights rounded
    once to bf16 for a bf16 cache, f32 value sum, output in the cache
    dtype."""
    _unsupported(k_rowscale, v_rowscale)
    b, d = q.shape
    hd = d // n_head
    k = _layer_view(k_cache, layer, batch_major)
    v = _layer_view(v_cache, layer, batch_major)
    bk = k.shape[0]
    if b != bk * kv_rep:
        raise ValueError(f"q batch {b} != kv batch {bk} * kv_rep {kv_rep}")
    cu = k.shape[1] if not c_used else min(int(c_used), k.shape[1])
    k, v = k[:, :cu], v[:, :cu]
    s = torch.einsum("brhe,bche->brhc",
                     q.float().reshape(bk, kv_rep, n_head, hd),
                     k.float().reshape(bk, cu, n_head, hd))
    hidden = (torch.arange(cu, device=q.device)
              > _rows(pos, b, q.device).long().reshape(bk, kv_rep, 1, 1))
    s = s.masked_fill(hidden, NEG_INF)
    w = torch.softmax(s, dim=-1)
    if v.dtype == torch.bfloat16:
        w = w.to(torch.bfloat16).float()
    o = torch.einsum("brhc,bche->brhe", w,
                     v.float().reshape(bk, cu, n_head, hd))
    return o.reshape(b, d).to(v.dtype)


def decode_attention_stacked(
    q: torch.Tensor,  # (B, d) single query, PRE-SCALED by hd^-0.5
    k_cache: torch.Tensor,  # (L, B, C, d), or (B, L, C, d) if batch_major
    v_cache: torch.Tensor,
    pos: Union[int, torch.Tensor],  # highest visible row: int or (B,) i32
    layer: int,
    n_head: int,
    batch_major: bool = False,
    kv_rep: int = 1,
    k_rowscale: Optional[torch.Tensor] = None,
    v_rowscale: Optional[torch.Tensor] = None,
    c_used: Optional[int] = None,  # read only rows [0, c_used)
) -> torch.Tensor:
    """Returns (B, d) in the cache dtype. CPU tensors take the plain
    version; CUDA tensors launch the Hopper kernel or raise (bf16 or f32
    q/k/v of one dtype, head dim 64, unit channel stride, 16-byte aligned
    rows, kv_rep <= MAX_REP). kv_rep = 1 is K3 (counted in `.launches`),
    kv_rep > 1 K3g (counted in `.group_launches`). The caller guarantees
    every pos < c_used."""
    _unsupported(k_rowscale, v_rowscale)
    if q.device.type == "cpu":
        return decode_attention_stacked_plain(
            q, k_cache, v_cache, pos, layer, n_head, batch_major, kv_rep,
            c_used=c_used)
    b, d = q.shape
    if not 1 <= kv_rep <= MAX_REP:
        raise ValueError(f"kv_rep {kv_rep} outside the kernel's 1..{MAX_REP}")
    dt = k_cache.dtype
    if dt not in TOL or q.dtype != dt or v_cache.dtype != dt:
        raise TypeError(f"decode attention kernel takes bf16 or f32 of one "
                        f"dtype, got q {q.dtype} k {dt} v {v_cache.dtype}")
    if d != n_head * _HD:
        raise ValueError(f"head dim {d // n_head} != {_HD}")
    if k_cache.shape != v_cache.shape:
        raise ValueError("k and v caches differ in shape")
    lane_dim, layer_dim = (0, 1) if batch_major else (1, 0)
    if k_cache.shape[lane_dim] * kv_rep != b:
        raise ValueError(f"q batch {b} != kv batch {k_cache.shape[lane_dim]}"
                         f" * kv_rep {kv_rep}")
    c = k_cache.shape[2]
    cu = c if not c_used else min(int(c_used), c)
    # 16-byte vector loads: unit channel stride, 16-byte aligned rows
    vec = 16 // k_cache.element_size()
    ks, vs, qs = k_cache.stride(), v_cache.stride(), q.stride()
    if (ks[3] != 1 or vs[3] != 1 or qs[1] != 1
            or (ks[0] | ks[1] | ks[2] | vs[0] | vs[1] | vs[2] | qs[0]) % vec
            or (q.data_ptr() | k_cache.data_ptr() | v_cache.data_ptr()) % 16):
        raise ValueError(f"q/k/v need unit channel stride and 16-byte aligned "
                         f"rows, got strides {qs} {ks} {vs}")
    pos_rows = pos if (isinstance(pos, torch.Tensor) and pos.shape == (b,)
                       and pos.dtype == torch.int32 and pos.is_cuda) \
        else _rows(pos, b, q.device).contiguous()
    out = torch.empty((b, d), dtype=dt, device=q.device)
    err = library().wtt_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        pos_rows.data_ptr(), out.data_ptr(), b, n_head, kv_rep, cu,
        int(layer), int(dt == torch.float32), qs[0], ks[lane_dim],
        ks[layer_dim], ks[2], vs[lane_dim], vs[layer_dim], vs[2],
        out.stride(0), stream_ptr(q))
    check(err, "wtt_decode_attention")
    if kv_rep == 1:
        decode_attention_stacked.launches += 1
    else:
        decode_attention_stacked.group_launches += 1
    return out


decode_attention_stacked.launches = 0
decode_attention_stacked.group_launches = 0
