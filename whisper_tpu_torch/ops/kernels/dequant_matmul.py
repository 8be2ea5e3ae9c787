"""W8A8 matrix products (int8 weights times per-row dynamic int8
activations): Hopper kernels, their plain PyTorch versions, and the
wrappers that pick between them by device.

Replaces two TPU kernels of `whisper_tpu/ops/pallas/dequant_matmul.py`:
  K6 `_w8a8_kernel`, entry `quantized_matmul` (the model sends M <= 1024
     rows here): the row scale xs = absmax * (1/127) (1 for a zero row),
     xq = clip(round(x / xs), -127, 127);
  K7 `_w8a8_big_kernel`, entry `quantized_matmul_big` (M > 1024): the
     same xs, but xq = clip(round(x * (127 / absmax)), -127, 127) (0 for a
     zero row) -- a different rounding, so the two are separate functions.
Both: acc = xq @ wq in exact int32, out = ((acc * xs) * ws) in out_dtype
(x's dtype by default); round is half to even. The bias is the caller's.

The CUDA source, `csrc/dequant_matmul.cu`, runs a row-quantize pass into
scratch and then an int8 tensor-core GEMM (mma.sync s8); the two launches
are one call of the kernel and count once. Its note reckons the bound.
Tolerance against the plain version: none, bit-equal (the same xq, an
exact integer sum and the same f32 epilogue).
"""

from __future__ import annotations

from typing import Optional

import torch

from ._build import check, library, stream_ptr

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


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


def _launch(x, wq, scale, out_dtype, big: bool) -> torch.Tensor:
    """Checks what the CUDA entry takes, raising on anything else, and
    launches it."""
    out_dtype = out_dtype or x.dtype
    if x.dim() != 2 or wq.dim() != 2 or x.shape[1] != wq.shape[0]:
        raise ValueError(f"W8A8 takes x (M, K) and wq (K, N), got "
                         f"{tuple(x.shape)} and {tuple(wq.shape)}")
    m, k = x.shape
    n = wq.shape[1]
    if wq.dtype != torch.int8:
        raise TypeError(f"W8A8 takes int8 weights, got {wq.dtype} (packed "
                        "int4 has no kernel)")
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
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    xs = torch.empty((m,), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    err = library().wtt_w8a8_matmul(
        x.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(),
        xq.data_ptr(), xs.data_ptr(), m, k, n, _DTYPES[x.dtype],
        _DTYPES[out_dtype], int(big), stream_ptr(x))
    check(err, "wtt_w8a8_matmul")
    return out


def quantized_matmul(x: torch.Tensor,  # (M, K) bf16 / f32
                     wq: torch.Tensor,  # (K, N) int8
                     scale: torch.Tensor,  # (N,) f32 per output column
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K6: (M, N) ~= x @ (wq * scale). CPU tensors take the plain version;
    CUDA tensors launch the Hopper kernel or raise (int8 wq, K and N
    multiples of 128, contiguous operands, bf16/f32)."""
    if x.device.type == "cpu":
        return quantized_matmul_plain(x, wq, scale, out_dtype)
    out = _launch(x, wq, scale, out_dtype, big=False)
    quantized_matmul.launches += 1
    return out


def quantized_matmul_big(x: torch.Tensor, wq: torch.Tensor,
                         scale: torch.Tensor,
                         out_dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """K7: as `quantized_matmul`, with the large-M kernel's rounding."""
    if x.device.type == "cpu":
        return quantized_matmul_big_plain(x, wq, scale, out_dtype)
    out = _launch(x, wq, scale, out_dtype, big=True)
    quantized_matmul_big.launches += 1
    return out


quantized_matmul.launches = 0
quantized_matmul_big.launches = 0
