"""W8A8 matrix products (int8 or packed-int4 weights times per-row
dynamic int8 activations): Hopper kernels, their plain PyTorch versions,
and the wrappers that pick between them by device.

Replaces two TPU kernels of `whisper_tpu/ops/pallas/dequant_matmul.py`:
  K6 `_w8a8_kernel`, entry `quantized_matmul` (the model sends M <= 1024
     rows here): the row scale xs = absmax * (1/127) (1 for a zero row),
     xq = clip(round(x / xs), -127, 127);
  K7 `_w8a8_big_kernel`, entry `quantized_matmul_big` (M > 1024): the
     same xs, but xq = clip(round(x * (127 / absmax)), -127, 127) (0 for a
     zero row) -- a different rounding, so the two are separate functions.
Both: acc = xq @ wq in exact int32, out = ((acc * xs) * ws) in out_dtype
(x's dtype by default); round is half to even. The bias is the caller's.
The weight is int8 (K, N), or packed int4 (K, N / 2) uint8 (quantize.py's
layout: low nibble = even column), the TPU kernels' `jnp.int4` weight: its
values are sign-extended to int8 where the kernel stages its weight tile,
so the products and the epilogue are the int8 path's.

The CUDA source, `csrc/dequant_matmul.cu`, has two paths. At M <= 64
rows (decode) one launch quantizes the rows inside an int8 tensor-core
GEMM (mma.sync s8) whose K is split over a cluster of blocks; the split is
`plan_small`'s. Above (the encoder), a prep pass (the rows quantized
into scratch, and the weight copied K-major into scratch on every call,
the layout wgmma takes for 8-bit operands) and then a warp-specialised TMA + wgmma
GEMM over 128 x 256 or 128 x 128 tiles: two launches that are one call
of the kernel and count once; the tile width is `plan_big`'s.
Its note reckons the bound.
Tolerance against the plain version: none, bit-equal (the same xq, an
exact integer sum and the same f32 epilogue).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...quantize import int_values
from ._build import check, library, refuse_grad, stream_ptr

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

N_SM = 132  # streaming multiprocessors of an H100 SXM
SMALL_M = 64  # rows the one-launch split-K kernel takes
MAX_KSPLIT = 8  # the portable cluster size
SPLIT_ROWS = 8  # activation rows a block of the split-K kernel
SPLIT_COLS = 128  # output columns a block
MAX_SLICE = 640  # K a block: bounds its shared memory
WHOLE_ROWS_BYTES = 10240  # x up to this size: every block reads it whole
BIG_ROWS = 128  # rows of a tile of the large-M kernel


def plan_small(m: int, k: int, n: int, x_bytes: int = 2) -> Tuple[int, bool]:
    """(ksplit, whole) of the one-launch kernel for m <= 64 rows of an x
    of `x_bytes`-byte values: the K split (cluster size), and whether
    each block takes the rows' absmax over the whole rows it reads (a
    small x) instead of exchanging its slice's maxima with the other
    ranks; (0, False) for the row-quantize pass + tile kernel (m > 64, or
    K past 8 x 640). A block has 8 warps and takes 128 columns, 8 rows
    and K / ksplit in steps of 32 k rows that its warps share round
    robin. The split is the largest whose grid holds one block an SM
    while half of a block's warps still have a step, else the smallest
    that fits (`tools/sweep_k6_plan.py` timed each choice at the decode
    rows)."""
    if m > SMALL_M:
        return 0, False
    steps = k // 32
    blocks = (n // SPLIT_COLS) * -(-m // SPLIT_ROWS)
    fits = [s for s in range(1, MAX_KSPLIT + 1)
            if steps % s == 0 and k // s <= MAX_SLICE]
    if not fits:
        return 0, False
    wave = [s for s in fits if steps // s >= 4 and blocks * s <= N_SM]
    return ((max(wave) if wave else min(fits)),
            m * k * x_bytes <= WHOLE_ROWS_BYTES)


def plan_big(m: int, n: int) -> int:
    """bn, the tile width of the large-M tile kernel (m > 64 rows): 128 x
    bn output tiles over the whole of K, bn 256 or 128 (a divisor of n). A
    block fills an SM (its ring takes 192 KB of shared memory), so a
    grid's last wave may leave SMs idle: the wide tile unless the narrow
    one's waves keep more than 1.05 times the share of the SMs busy.
    Large-v2's batched encoder (m = 3000) takes the wide tile at every
    weight shape;
    one window (m = 750) and two (1500) the narrow one where n = 1280,
    two windows also at n = 3840. `tools/sweep_k7_plan.py` times both
    (patching this function)."""
    def fill(bn):
        blocks = -(-m // BIG_ROWS) * (n // bn)
        return blocks / (-(-blocks // N_SM) * N_SM)

    return 128 if n % 256 or fill(128) > 1.05 * fill(256) else 256


def quantize_rows_plain(x: torch.Tensor, big: bool):
    """(xq int8 (M, K), xs f32 (M, 1)): K6's rounding, or K7's with
    `big`."""
    x32 = x.float()
    absmax = x32.abs().amax(dim=1, keepdim=True)
    xs = torch.where(absmax > 0, absmax * (1.0 / 127.0), 1.0)
    if big:  # a true division: `127.0 / t` is t.reciprocal() * 127
        inv = torch.where(absmax > 0, torch.full_like(absmax, 127.0) / absmax,
                          0.0)
        r = torch.round(x32 * inv)
    else:
        r = torch.round(x32 / xs)
    return torch.clamp(r, -127, 127).to(torch.int8), xs


def _w8a8_plain(x, wq, scale, out_dtype, big: bool) -> torch.Tensor:
    xq, xs = quantize_rows_plain(x, big)
    wq = int_values(wq)  # packed int4 -> its int8 values
    if x.device.type == "cpu":  # int32 products are exact
        acc = torch.matmul(xq.to(torch.int32), wq.to(torch.int32)).float()
    else:  # no integer matmul there: f64 is exact (|acc| <= 127^2 K < 2^53)
        acc = torch.matmul(xq.double(), wq.double()).float()
    return (acc * xs * scale.float()).to(out_dtype or x.dtype)


def quantized_matmul_plain(x, wq, scale, out_dtype=None) -> torch.Tensor:
    """K6's arithmetic in plain PyTorch."""
    return _w8a8_plain(x, wq, scale, out_dtype, big=False)


def quantized_matmul_big_plain(x, wq, scale, out_dtype=None) -> torch.Tensor:
    """K7's arithmetic in plain PyTorch."""
    return _w8a8_plain(x, wq, scale, out_dtype, big=True)


def _launch(x, wq, scale, out_dtype, big: bool,
            plan: Optional[Tuple[int, bool]] = None
            ) -> Tuple[torch.Tensor, bool]:
    """Checks what the CUDA entry takes, raising on anything else, and
    launches it; `plan` overrides `plan_small`'s (ksplit 0: the two-launch
    path, over `plan_big`'s tile width). Returns the output and whether
    the call took the two-launch large-M route."""
    out_dtype = out_dtype or x.dtype
    if x.dim() != 2 or wq.dim() != 2 or x.shape[1] != wq.shape[0]:
        raise ValueError(f"W8A8 takes x (M, K) and wq (K, N), got "
                         f"{tuple(x.shape)} and {tuple(wq.shape)}")
    m, k = x.shape
    if wq.dtype not in (torch.int8, torch.uint8):
        raise TypeError(f"W8A8 takes int8 or packed-int4 (uint8) weights, "
                        f"got {wq.dtype}")
    int4 = wq.dtype == torch.uint8
    n = wq.shape[1] * (2 if int4 else 1)
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"W8A8 takes bf16/f32 x and output, got {x.dtype} "
                        f"-> {out_dtype}")
    if k % 128 or n % 128:
        raise ValueError(f"W8A8 needs K and N multiples of 128, got K={k} "
                         f"N={n}")
    if (scale.dtype != torch.float32 or scale.numel() != n
            or not all(t.is_cuda and t.is_contiguous() for t in (x, wq, scale))
            or wq.data_ptr() % 16):
        raise ValueError("W8A8 takes contiguous CUDA x, 16-byte aligned wq "
                         "and f32 (N,) scales")
    scale = scale.reshape(n)
    ksplit, whole = plan or plan_small(m, k, n, x.element_size())
    bn = 0
    if x.data_ptr() % 16:  # the kernels read x 16 bytes at a time
        x = x.clone()
    scratch = (None, None, None)
    if not ksplit:  # the row-quantized x, its scales, the K-major weight
        bn = plan_big(m, n)
        scratch = (torch.empty((m, k), dtype=torch.int8, device=x.device),
                   torch.empty((m,), dtype=torch.float32, device=x.device),
                   torch.empty((n, k), dtype=torch.int8, device=x.device))
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    err = library().wtt_w8a8_matmul(
        x.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(),
        *(None if t is None else t.data_ptr() for t in scratch), m, k, n,
        _DTYPES[x.dtype], _DTYPES[out_dtype], int(big), int(int4), ksplit,
        int(whole), bn, stream_ptr(x))
    check(err, "wtt_w8a8_matmul")
    return out, not ksplit


def _count(fn, wq) -> None:
    """One launch on the wrapper's counter: `.launches` for int8 weights,
    `.int4_launches` for packed int4."""
    if wq.dtype == torch.uint8:
        fn.int4_launches += 1
    else:
        fn.launches += 1


def quantized_matmul(x: torch.Tensor,  # (M, K) bf16 / f32
                     wq: torch.Tensor,  # (K, N) int8, or (K, N/2) packed int4
                     scale: torch.Tensor,  # (N,) f32 per output column
                     out_dtype: Optional[torch.dtype] = None,
                     plan: Optional[Tuple[int, bool]] = None
                     ) -> torch.Tensor:
    """K6: (M, N) ~= x @ (wq * scale). CPU tensors take the plain version;
    CUDA tensors launch the Hopper kernel or raise (int8 or packed-int4
    wq, K and N multiples of 128, contiguous operands, bf16/f32).
    `plan` forces (ksplit, whole) instead of `plan_small`'s (ksplit 0: the
    two-launch path). Calls that take the two-launch route (above 64 rows)
    are also counted in `.tile_launches`."""
    if x.device.type == "cpu":
        return quantized_matmul_plain(x, wq, scale, out_dtype)
    refuse_grad("quantized_matmul", x, scale)
    out, tiled = _launch(x, wq, scale, out_dtype, False, plan)
    _count(quantized_matmul, wq)
    quantized_matmul.tile_launches += tiled
    return out


def quantized_matmul_big(x: torch.Tensor, wq: torch.Tensor,
                         scale: torch.Tensor,
                         out_dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """K7: as `quantized_matmul`, with the large-M kernel's rounding."""
    if x.device.type == "cpu":
        return quantized_matmul_big_plain(x, wq, scale, out_dtype)
    refuse_grad("quantized_matmul_big", x, scale)
    out, _ = _launch(x, wq, scale, out_dtype, True)
    _count(quantized_matmul_big, wq)
    return out


quantized_matmul.launches = 0
quantized_matmul.int4_launches = 0
quantized_matmul.tile_launches = 0
quantized_matmul_big.launches = 0
quantized_matmul_big.int4_launches = 0
