"""Encoder self-attention: Hopper kernel, its plain PyTorch version, and the
wrapper that picks between them by device.

Replaces two TPU kernels of `whisper_tpu/ops/pallas/flash_attention.py`:
  K1 `_attn_bsd_kernel` (entry `attention_bhsd` -> `_attention_bsd`), on the
     natural (B, S, d) layout, heads as column slices;
  K9 `_attn_kernel` (entry `flash_attention`, on (B, H, S, hd)), which
     `attention_bhsd` runs under impl="legacy" -- the JAX package's
     WHISPER_TPU_FLASH_IMPL=legacy, here `KernelKnobs.flash_impl`.
The CUDA source, `csrc/flash_attention.cu`, is a warp-specialised
FlashAttention-3-shaped kernel for Hopper: one block per (128 query rows,
head, batch), a producer warpgroup streaming 128-key K/V tiles by TMA into
a 3-stage shared-memory ring (mbarriers), two consumer warpgroups running
the `wgmma` products with the online softmax in registers. The host entry
builds TMA maps over the tensors' batch, head and row strides, so both
layouts are views and nothing is transposed in memory. What bounds it and
why it streams K/V instead of keeping a head resident as the TPU kernels
do is in the source's note.

Tolerance against the plain version (bf16 in, bf16 out, v of order 1):
elementwise |kernel - plain| <= ATOL + RTOL * |plain|. The plain version
normalises the softmax weights before rounding them to bf16 for PV; the
kernel rounds the unnormalised exp(s - m) and divides once at the end.
So each output may land one bf16 step (at most 2^-7 relative, under RTOL)
away,
and where few keys carry the weight (the first rows of a causal map) the
two roundings of p move the f32 sum by up to ~2^-8 * sum_j p_j |v_j|
before that step, which ATOL covers for |v| of order 1. A kernel that let
the zero-filled keys past Sk into the softmax would shrink every output
by about (keys of padding) / (Sk * e^0.5): at Sk = 705 (63 padded keys)
that is ~5%, several times this tolerance once |out| is near 1. K9 holds
the same tolerance against `flash_attention_plain`.
"""

from __future__ import annotations

import torch

from ...config import FLASH_IMPLS
from ._build import check, library, refuse_grad, stream_ptr

ATOL = 1e-2
RTOL = 1.2e-2
_HD = 64
NEG_INF = -1e30  # the TPU kernels' mask value


def attention_bhsd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         n_head: int, causal: bool = False) -> torch.Tensor:
    """(B, S, d) multi-head attention, heads as column slices.

    Mirrors the TPU kernel's legacy softmax path: q pre-scaled by
    hd^-0.5 in its own dtype, f32 scores, keys past the key length
    masked, p normalised then cast to v's dtype, f32 accumulation,
    output in v's dtype."""
    b, sq, d = q.shape
    sk = k.shape[1]
    hd = d // n_head
    qh = (q * float(hd) ** -0.5).reshape(b, sq, n_head, hd).transpose(1, 2)
    kh = k.reshape(b, sk, n_head, hd).transpose(1, 2)
    vh = v.reshape(b, sk, n_head, hd).transpose(1, 2)
    # f32 products of the stored values: exact, as the TPU MXU's bf16 x bf16
    # -> f32 accumulation
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.matmul(p.float(), vh.float()).to(v.dtype)
    return o.transpose(1, 2).reshape(b, sq, d)


def _launch(q, k, v, out, causal: bool, scale: float) -> None:
    """Launch the CUDA kernel on (B, H, S, hd) views (any batch, head and
    row strides that keep 16-byte aligned rows of unit channel stride: the
    TMA maps' rules) after checking what it takes; counts nothing."""
    b, h, s, hd = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, hd) or v.shape != k.shape:
        raise ValueError(f"shapes differ: q {q.shape} k {k.shape} v {v.shape}")
    if hd != _HD:
        raise ValueError(f"head dim {hd} != {_HD}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
        if (t.stride(3) != 1 or any(x % 8 for x in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"{name} needs unit channel stride and 16-byte "
                             f"aligned rows, got strides {t.stride()}")
    err = library().wtt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, sk,
        h, int(causal), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], scale, stream_ptr(q))
    check(err, "wtt_flash_attention")


def _heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """(B, S, d) -> the (B, H, S, hd) view, heads as column slices."""
    b, s, d = x.shape
    return x.reshape(b, s, n_head, d // n_head).transpose(1, 2)


def attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   n_head: int, causal: bool = False,
                   impl: str = "bsd") -> torch.Tensor:
    """Drop-in for `qkv_attention` on the (B, S, d) layout (q unscaled).

    impl="bsd" (the default) is K1; impl="legacy" scales q by hd^-0.5 in
    its dtype, views the heads as (B, H, S, hd) and calls
    `flash_attention` (K9), as the JAX `attention_bhsd` does under
    WHISPER_TPU_FLASH_IMPL=legacy (flash_attention.py:359-363); other
    values raise ValueError. CPU tensors take the plain versions. CUDA
    tensors launch the Hopper kernel or raise: bf16 q (B, Sq, d) and k/v
    (B, Sk, d) with unit channel stride (the strided q/k/v slices of the
    fused QKV projection are fine) and head dim 64. K1 is counted in
    `.launches`, K9 in `flash_attention.launches`."""
    if impl not in FLASH_IMPLS:
        raise ValueError(f"flash impl must be one of {FLASH_IMPLS}, got "
                         f"{impl!r}")
    b, s, d = q.shape
    if impl == "legacy":
        scale = float(d // n_head) ** -0.5
        o = flash_attention(_heads(q * scale, n_head), _heads(k, n_head),
                            _heads(v, n_head), causal)
        return o.transpose(1, 2).reshape(b, s, d)
    if q.device.type == "cpu":
        return attention_bhsd_plain(q, k, v, n_head, causal)
    refuse_grad("attention_bhsd", q, k, v)
    if d != n_head * _HD:
        raise ValueError(f"head dim {d // n_head} != {_HD}")
    out = torch.empty((b, s, d), dtype=q.dtype, device=q.device)
    _launch(_heads(q, n_head), _heads(k, n_head), _heads(v, n_head),
            _heads(out, n_head), causal, float(_HD) ** -0.5)
    attention_bhsd.launches += 1
    return out


attention_bhsd.launches = 0


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False) -> torch.Tensor:
    """The TPU kernel `_attn_kernel` in plain PyTorch: q (B, H, Sq, hd)
    pre-scaled, k/v (B, H, Sk, hd); f32 scores of the f32-cast q and k,
    keys past the causal diagonal (j > i, on the absolute query row) set to
    -1e30, max-subtracted exp, p normalised then cast to v's dtype, f32
    value sum, output (B, H, Sq, hd) in v's dtype. The TPU kernel's key
    padding to a multiple of 128 is masked there, so it is left out."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if causal:
        sq, sk = s.shape[-2:]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (p / p.sum(dim=-1, keepdim=True)).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(v.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """K9, the JAX `flash_attention` (flash_attention.py:80): q (B, H, Sq,
    hd) PRE-SCALED by hd^-0.5, k/v (B, H, Sk, hd); returns (B, H, Sq, hd)
    in v's dtype.

    CPU tensors take `flash_attention_plain`. CUDA tensors launch the
    kernel of `csrc/flash_attention.cu` with the views' own strides (no
    transposed copy) and scale 1, or raise: bf16 only (TypeError
    otherwise), head dim 64, unit channel stride, 16-byte aligned rows.
    The output is written in (B, Sq, H, hd) memory order and returned as
    its (B, H, Sq, hd) view, so the (B, S, d) caller's transpose back is
    free. Counted in `.launches`."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    refuse_grad("flash_attention", q, k, v)
    b, h, s, hd = q.shape
    out = torch.empty((b, s, h, hd), dtype=v.dtype,
                      device=q.device).transpose(1, 2)
    _launch(q, k, v, out, causal, 1.0)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
