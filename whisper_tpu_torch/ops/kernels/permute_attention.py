"""Fused beam reshuffle + append + single-query self-attention over one
layer of the quantized self-KV cache, int8 or packed int4 (K5): Hopper
kernel, its plain PyTorch version, and the wrapper that picks between them
by device.

Replaces the TPU kernel `whisper_tpu/ops/pallas/permute_attention.py::
_fused_kernel` (entry `decode_attention_permute_fused`): per lane i, read
the parent slab `parents[i]` (rows [0, pos) of K, V and their f32 row
scales), append the lane's new quantized row and its scales at `pos`,
attend with the lane's query (K3s's arithmetic), and write the slab to
slot `dests[i]` -- reshuffle, append and attention in one cache pass,
replacing K4's permute, the two appends and K3s's read on the beam path.
The caches and the new rows are int8 (B, L, C, d) / (B, d), or packed int4
(uint8, quantize.py's layout) (B, L, C, d / 2) / (B, d / 2): a row of
d / 2 bytes, copied as bytes and unpacked in registers as K3s unpacks it.

The JAX kernel returns new arrays aliased to its inputs; here the caches
are updated IN PLACE and returned (the same tensors), as K4's wrapper
writes into caller buffers. Copy-on-write (`dests`, decode/beam.py::
_cow_assign): a lane with dests[i] == parents[i] stays in its slot and
writes only row pos; a lane that moves writes rows [0, pos] to a slot no
lane reads this step. Rows past pos of a written slot keep their old
contents (the TPU kernel copies its c_used block there; no reader looks
past pos). Contract, as in JAX: parents and dests are window-local
(parents[i] // beam_k == i // beam_k), dests are injective, and a staying
lane's slot already holds its slab. The CUDA kernel (`csrc/
permute_attention.cu`) runs one block per (head, lane) in no order and is
safe in place under that contract when every lane appends at the same pos
(an int `pos`: a beam step). Otherwise the wrapper reads from a staged
copy of the layer's caches: `dests=None` (identity slots, where a lane
may overwrite a slab that another lane reads), and a per-lane `pos`
tensor (a staying lane's row pos may lie inside the rows another claimant
of its slot reads). On the in-place path a call is ONE launch: the kernel
reads int64 parents and dests (`_cow_assign`'s) as they are and takes the
int pos as an argument, so the wrapper converts and fills nothing.
`stage` (the TPU kernel's read dedup) is accepted and changes nothing:
every block reads its own parent, and lanes that share one find its rows
in the L2.

Tolerance against the plain version: the attention output as K3s,
decode_attention.TOL[q.dtype]; the caches and scales bit-equal (copies).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ._build import check, library, refuse_grad, stream_ptr
from .decode_attention import _HD, _rows, decode_attention_stacked_plain


def _check_window(b: int, beam_k: int) -> None:
    if beam_k < 1 or b % beam_k:
        raise ValueError(f"batch {b} not divisible by beam_k {beam_k}")


def decode_attention_permute_fused_plain(
    q, k_cache, v_cache, k_scale, v_scale, new_k, new_v, new_ks, new_vs,
    parents, pos, layer: int, n_head: int, beam_k: int,
    c_used: Optional[int] = None, dests=None, stage=None,
):
    """The kernel's semantics in plain PyTorch: every lane's parent slab is
    gathered (a copy, so all reads precede all writes) with its new row
    patched in at pos, attended by `decode_attention_stacked_plain` with
    the row scales, and written back in place: rows [0, pos] for a lane
    that moves, row pos for one that stays, nothing past pos."""
    b = q.shape[0]
    _check_window(b, beam_k)
    dev = q.device
    c = k_cache.shape[2]
    cu = c if not c_used else min(int(c_used), c)
    pos_rows = _rows(pos, b, dev).long()
    par = parents.to(device=dev, dtype=torch.long)
    dst = (torch.arange(b, device=dev) if dests is None
           else dests.to(device=dev, dtype=torch.long))
    lanes = torch.arange(b, device=dev)
    staged = []
    for arr, new in ((k_cache, new_k), (v_cache, new_v), (k_scale, new_ks),
                     (v_scale, new_vs)):
        s = arr[par, layer]  # (B, C, ...) copy of the parents' slabs
        s[lanes, pos_rows] = new.to(s.dtype)
        staged.append(s)
    kq, vq, ks, vs = staged
    attn = decode_attention_stacked_plain(
        q, kq[:, None], vq[:, None], pos_rows.to(torch.int32), 0, n_head,
        batch_major=True, k_rowscale=ks[:, None], v_rowscale=vs[:, None],
        c_used=cu)
    rows = torch.arange(c, device=dev)[None, :]
    at = pos_rows[:, None]
    write = (((dst != par)[:, None] & (rows <= at)) | (rows == at)) & (rows < cu)
    for arr, s in zip((k_cache, v_cache, k_scale, v_scale), staged):
        m = write if s.dim() == 2 else write[..., None]
        arr[dst, layer] = torch.where(m, s, arr[dst, layer])
    return attn, k_cache, v_cache, k_scale, v_scale


def _vec(t, b: int, dev) -> torch.Tensor:
    """(B,) int64 as the kernel reads indices and a per-lane pos: the
    tensor itself when it already is one (no launch), else a copy."""
    if (t.device == dev and t.dtype == torch.int64 and t.shape == (b,)
            and t.is_contiguous()):
        return t
    return t.to(device=dev, dtype=torch.int64).reshape(-1).expand(b) \
        .contiguous()


def decode_attention_permute_fused(
    q: torch.Tensor,  # (B, d) single query, PRE-SCALED by hd^-0.5
    k_cache: torch.Tensor,  # (B, L, C, d) int8 or (B, L, C, d/2) packed
    v_cache: torch.Tensor,  # int4 (uint8), updated in place
    k_scale: torch.Tensor,  # (B, L, C) f32 row scales, updated in place
    v_scale: torch.Tensor,  # (B, L, C) f32, updated in place
    new_k: torch.Tensor,  # (B, d) int8 or (B, d/2) packed int4: this
    new_v: torch.Tensor,  # step's quantized rows, the caches' dtype
    new_ks: torch.Tensor,  # (B,) f32: their scales
    new_vs: torch.Tensor,  # (B,) f32
    parents: torch.Tensor,  # (B,) int: window-local beam parents
    pos: Union[int, torch.Tensor],  # append row AND highest visible row
    layer: int,
    n_head: int,
    beam_k: int,  # lanes per window
    c_used: Optional[int] = None,  # every pos < c_used
    dests: Optional[torch.Tensor] = None,  # (B,) int: COW write slots
    stage: Optional[torch.Tensor] = None,  # accepted; changes nothing
):
    """Returns (attn (B, d) in q's dtype, k_cache, v_cache, k_scale,
    v_scale): the same cache tensors, permuted and appended in place
    (module doc). Pass `pos` as an int for the in-place copy-on-write
    path; a tensor `pos` makes the CUDA wrapper stage its reads. CPU
    tensors take the plain version; CUDA tensors launch the Hopper kernel
    (counted in `.launches` over int8 caches, `.int4_launches` over packed
    int4) or raise: int8 or packed-int4 caches and new rows of one dtype,
    head dim 64, unit channel stride and 16-byte aligned rows, f32 scales
    with contiguous rows, a bf16 or f32 query."""
    b, d = q.shape
    _check_window(b, beam_k)
    if q.device.type == "cpu":
        return decode_attention_permute_fused_plain(
            q, k_cache, v_cache, k_scale, v_scale, new_k, new_v, new_ks,
            new_vs, parents, pos, layer, n_head, beam_k, c_used, dests, stage)
    refuse_grad("decode_attention_permute_fused", q, k_scale, v_scale,
                new_ks, new_vs)
    sd = k_cache.dtype
    if (sd not in (torch.int8, torch.uint8)
            or any(t.dtype != sd for t in (v_cache, new_k, new_v))
            or q.dtype not in (torch.bfloat16, torch.float32)
            or k_scale.dtype != torch.float32
            or v_scale.dtype != torch.float32):
        raise TypeError(f"the fused kernel takes int8 or packed-int4 (uint8) "
                        f"caches and rows of one dtype, f32 scales and a "
                        f"bf16/f32 query; got q {q.dtype} k {sd} v "
                        f"{v_cache.dtype} new rows {new_k.dtype} "
                        f"{new_v.dtype} scales {k_scale.dtype} "
                        f"{v_scale.dtype}")
    if d != n_head * _HD:
        raise ValueError(f"head dim {d // n_head} != {_HD}")
    int4 = sd == torch.uint8
    row = d // 2 if int4 else d  # stored elements (bytes) of a row
    shape = k_cache.shape
    if (v_cache.shape != shape or shape[0] != b or shape[3] != row
            or k_scale.shape != shape[:3] or v_scale.shape != shape[:3]
            or new_k.shape != (b, row) or new_v.shape != (b, row)):
        raise ValueError(f"shapes do not match: q {tuple(q.shape)} caches "
                         f"{tuple(shape)} scales {tuple(k_scale.shape)} new "
                         f"rows {tuple(new_k.shape)}")
    ks, qs = k_cache.stride(), q.stride()
    if (v_cache.stride() != ks or ks[3] != 1 or any(x % 16 for x in ks[:3])
            or k_scale.stride() != v_scale.stride() or k_scale.stride(2) != 1
            or qs[1] != 1 or qs[0] * q.element_size() % 16
            or new_k.stride() != (row, 1) or new_v.stride() != (row, 1)
            or (q.data_ptr() | k_cache.data_ptr() | v_cache.data_ptr()
                | new_k.data_ptr() | new_v.data_ptr()) % 16):
        raise ValueError("caches need unit channel stride, 16-byte aligned "
                         "rows and k/v of one layout; scales contiguous rows")
    dev = q.device
    c = shape[2]
    cu = c if not c_used else min(int(c_used), c)
    par = _vec(parents, b, dev)
    dst = (torch.arange(b, dtype=torch.int64, device=dev) if dests is None
           else _vec(dests, b, dev))
    per_lane = isinstance(pos, torch.Tensor)
    pos_rows = _vec(pos, b, dev) if per_lane else None
    if not per_lane and not 0 <= int(pos) < cu:
        raise ValueError(f"pos {int(pos)} outside [0, c_used={cu})")
    k_l, v_l = k_cache[:, layer], v_cache[:, layer]
    ks_l, vs_l = k_scale[:, layer], v_scale[:, layer]
    if dests is None or per_lane:
        # a write could land on rows another block reads (module doc):
        # read from a copy of the layer
        k_src, v_src = k_l[:, :cu].clone(), v_l[:, :cu].clone()
        ks_src, vs_src = ks_l.clone(), vs_l.clone()
    else:
        k_src, v_src, ks_src, vs_src = k_l, v_l, ks_l, vs_l
    nks = new_ks.to(torch.float32).contiguous()
    nvs = new_vs.to(torch.float32).contiguous()
    out = torch.empty((b, d), dtype=q.dtype, device=dev)
    err = library().wtt_permute_attention(
        q.data_ptr(), k_src.data_ptr(), v_src.data_ptr(), ks_src.data_ptr(),
        vs_src.data_ptr(), k_l.data_ptr(), v_l.data_ptr(), ks_l.data_ptr(),
        vs_l.data_ptr(), new_k.data_ptr(), new_v.data_ptr(), nks.data_ptr(),
        nvs.data_ptr(), par.data_ptr(), dst.data_ptr(),
        pos_rows.data_ptr() if per_lane else None, out.data_ptr(), b,
        n_head, cu, cu if per_lane else int(pos) + 1,
        0 if per_lane else int(pos), int(int4), int(q.dtype == torch.float32),
        qs[0], k_src.stride(0), k_src.stride(1), ks_src.stride(0),
        k_l.stride(0), k_l.stride(1), ks_l.stride(0), row, out.stride(0),
        stream_ptr(q))
    check(err, "wtt_permute_attention")
    if int4:
        decode_attention_permute_fused.int4_launches += 1
    else:
        decode_attention_permute_fused.launches += 1
    return out, k_cache, v_cache, k_scale, v_scale


decode_attention_permute_fused.launches = 0
decode_attention_permute_fused.int4_launches = 0
