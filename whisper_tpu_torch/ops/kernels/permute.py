"""Lane permute for the beam-search cache reshuffle: Hopper kernel, its
plain PyTorch version, and the wrapper that picks between them by device.

Replaces the TPU kernels `whisper_tpu/ops/pallas/permute.py::
_permute_dma_kernel` (whole slabs) and `::_permute_prefix_kernel` (a
valid-row prefix), entry `permute_lanes_arrays`: `out[a][i] =
arrays[a][parents[i]]` over the leading (lane) axis of several arrays in
ONE launch. The CUDA source, `csrc/permute.cu`, is a copy kernel over a
(slab chunk, lane, array) grid, 16 bytes per thread per load; its note
reckons the bytes that bound it.

The JAX kernel returns new arrays. Here the caller passes the `out`
buffers and the kernel writes into them (an in-place design: the beam
loop keeps two self-KV buffer pairs and swaps them every step), so no
allocation happens per step. An `out` that overlaps an input raises: the
kernel reads every parent slab while other lanes' writes are in flight.

With `valid_len`, the arrays marked in `chunk_mask` (default: every
rank-4 array, row axis 2) copy only rows [0, ceil(valid_len/chunk)*chunk)
and leave the rest of `out` as it was; the other arrays copy whole slabs.
Tolerance against the plain version: bit-exact (a copy).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from ._build import check, library, refuse_grad, stream_ptr

MAX_ARRAYS = 8  # the kernel's argument block holds this many arrays


def _bytes(t: torch.Tensor) -> Tuple[int, int]:
    start = t.data_ptr()
    return start, start + t.numel() * t.element_size()


def _check_args(arrays, out, chunk, chunk_mask, valid_len):
    if len(out) != len(arrays):
        raise ValueError(f"{len(arrays)} arrays but {len(out)} out buffers")
    b = arrays[0].shape[0]
    for a, o in zip(arrays, out):
        if a.shape[0] != b:
            raise ValueError("arrays differ in their lane count")
        if o.shape != a.shape or o.dtype != a.dtype or o.device != a.device:
            raise ValueError(f"out {tuple(o.shape)} {o.dtype} does not match "
                             f"its array {tuple(a.shape)} {a.dtype}")
        if not (a.is_contiguous() and o.is_contiguous()):
            raise ValueError("permute takes contiguous arrays and out buffers")
    ranges = [_bytes(t) for t in arrays]
    for o in out:
        lo, hi = _bytes(o)
        if any(lo < b_hi and b_lo < hi for b_lo, b_hi in ranges):
            raise ValueError("an out buffer overlaps an input array")
    if chunk_mask is None:
        chunk_mask = tuple(a.dim() >= 4 for a in arrays)
    if valid_len is not None:
        for a, m in zip(arrays, chunk_mask):
            if m and a.shape[2] % chunk:
                raise ValueError(f"chunked array row count {a.shape[2]} must "
                                 f"be a multiple of chunk={chunk}")
    return tuple(chunk_mask)


def _prefix_rows(valid_len, chunk: int, rows: int) -> int:
    return min(-(-int(valid_len) // chunk) * chunk, rows)


def permute_lanes_arrays_plain(
    arrays: Sequence[torch.Tensor],
    parents: torch.Tensor,
    out: Sequence[torch.Tensor],
    valid_len: Optional[int] = None,
    chunk: int = 32,
    chunk_mask: Optional[Sequence[bool]] = None,
) -> Tuple[torch.Tensor, ...]:
    """`out[a][i] = arrays[a][parents[i]]` with index_select, into `out`;
    with `valid_len`, only the row prefix of the chunked arrays."""
    mask = _check_args(arrays, out, chunk, chunk_mask, valid_len)
    idx = parents.to(device=arrays[0].device, dtype=torch.long)
    for a, o, m in zip(arrays, out, mask):
        if valid_len is None or not m:
            o.copy_(a.index_select(0, idx))
        else:
            n = _prefix_rows(valid_len, chunk, a.shape[2])
            o[:, :, :n] = a.index_select(0, idx)[:, :, :n]
    return tuple(out)


def permute_lanes_arrays(
    arrays: Sequence[torch.Tensor],  # (B, ...) each, sharing the lane axis
    parents: torch.Tensor,  # (B,) int: out[a][i] = arrays[a][parents[i]]
    out: Sequence[torch.Tensor],  # buffers shaped like `arrays`, written
    valid_len: Optional[int] = None,  # copy only rows [0, valid) of ...
    chunk: int = 32,  # ... in whole chunks of this many rows ...
    chunk_mask: Optional[Sequence[bool]] = None,  # ... of these arrays
) -> Tuple[torch.Tensor, ...]:
    """Returns `out`. CPU tensors take the plain version; CUDA tensors
    launch the Hopper kernel or raise (contiguous arrays, 16-byte aligned
    slabs and rows, at most MAX_ARRAYS arrays, parents in [0, B))."""
    arrays, out = tuple(arrays), tuple(out)
    if arrays[0].device.type == "cpu":
        return permute_lanes_arrays_plain(arrays, parents, out, valid_len,
                                          chunk, chunk_mask)
    refuse_grad("permute_lanes_arrays", *arrays, *out)
    mask = _check_args(arrays, out, chunk, chunk_mask, valid_len)
    n = len(arrays)
    if n > MAX_ARRAYS:
        raise ValueError(f"{n} arrays: the kernel takes at most {MAX_ARRAYS}")
    b = arrays[0].shape[0]
    geom = []
    for a, m in zip(arrays, mask):
        es = a.element_size()
        lane_bytes = a[0].numel() * es
        if valid_len is None or not m:
            geom += [lane_bytes, 1, lane_bytes, lane_bytes]
        else:  # (B, L, C, ...): L segments of the first rows of C
            row_bytes = a[0, 0, 0].numel() * es
            seg_stride = a.shape[2] * row_bytes
            rows = _prefix_rows(valid_len, chunk, a.shape[2])
            geom += [lane_bytes, a.shape[1], seg_stride, rows * row_bytes]
    if any(g % 16 for g in geom[0::4] + geom[2::4] + geom[3::4]):
        raise ValueError(f"slabs and rows must be multiples of 16 bytes, got "
                         f"(lane, n_seg, seg_stride, seg_bytes) {geom}")
    par = parents.to(device=arrays[0].device, dtype=torch.int32).contiguous()
    if par.shape != (b,):
        raise ValueError(f"parents shape {tuple(par.shape)} != ({b},)")
    src = (ctypes.c_uint64 * n)(*(a.data_ptr() for a in arrays))
    dst = (ctypes.c_uint64 * n)(*(o.data_ptr() for o in out))
    g = (ctypes.c_longlong * (4 * n))(*geom)
    err = library().wtt_permute_lanes(
        n, b, par.data_ptr(), ctypes.addressof(src), ctypes.addressof(dst),
        ctypes.addressof(g), stream_ptr(arrays[0]))
    check(err, "wtt_permute_lanes")
    permute_lanes_arrays.launches += 1
    return out


permute_lanes_arrays.launches = 0
