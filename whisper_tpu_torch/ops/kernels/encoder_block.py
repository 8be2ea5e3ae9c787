"""Fused encoder MLP sub-block: Hopper kernel, its plain PyTorch version,
and the wrapper that picks between them by device.

    out = x + gelu_exact(layer_norm(x) @ w1 + b1) @ w2 + b2

Replaces the TPU kernel `whisper_tpu/ops/pallas/encoder_block.py::
_mlp_kernel` (entry `fused_mlp_block` -> `_mlp_call`). The CUDA source,
`csrc/encoder_mlp.cu`, runs three launches: a layer-norm row pass, then
two warp-specialised wgmma + TMA GEMMs, the first with the bias and the
exact GELU in its epilogue (writing the (M, 4d) bf16 hidden, which stays
in L2), the second with the bias and the residual in its epilogue and,
at small M, a split over K combined inside a two-block cluster
(`plan_ksplit`). Its note says what bounds it and why it does not copy the
TPU kernel's (1024, d) VMEM accumulator.

Tolerance against the plain version (bf16 in, bf16 out): elementwise
|kernel - plain| <= ATOL + RTOL * |plain|. Both round in the same places
(LN -> bf16, GELU output -> bf16, one final rounding); only the f32
summation order differs, which can move a bf16 intermediate or the
output by one rounding step (2^-8 relative).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ._build import check, library, refuse_grad, stream_ptr

ATOL = 2e-2
RTOL = 1e-2


def fused_mlp_block_plain(x, ln_g, ln_b, w1, b1, w2, b2, eps: float = 1e-5):
    """The TPU kernel's arithmetic in plain PyTorch: LN in f32 rounded to
    x's dtype, GEMM1 with f32 accumulation + b1 in f32, exact-erf GELU in
    f32 rounded to x's dtype, GEMM2 with f32 accumulation, then
    x + acc + b2 in f32 rounded once."""
    lead, d = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, d).float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    hn = ((xf - mu) * torch.rsqrt(var + eps) * ln_g.float()
          + ln_b.float()).to(x.dtype)
    t = torch.matmul(hn.float(), w1.float()) + b1.float()
    t = F.gelu(t).to(x.dtype)
    acc = torch.matmul(t.float(), w2.float())
    return (xf + acc + b2.float()).to(x.dtype).reshape(*lead, d)


@functools.lru_cache(maxsize=8)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def plan_ksplit(m: int, d: int, n_sm: int) -> int:
    """GEMM2's cluster size over K (1 or 2). GEMM2 (hidden @ w2, N = d)
    has ceil(m / 128) x d / 128 tiles; a split of 2 doubles the blocks and
    halves each block's work. It is taken only when the split grid still
    fits in one wave (2 x tiles <= n_sm), the case measured faster: at
    M = 750, d = 1280 on 132 SMs (60 tiles) the split GEMM2 beat the
    unsplit one, while at M = 6000 (470 tiles) it was slower (PERF.md
    section 6). Large-v2 on 132 SMs: 2 at one window, 1 from two."""
    tiles = -(-m // 128) * (d // 128)
    return 2 if 2 * tiles <= n_sm else 1


def fused_mlp_block(x, ln_g, ln_b, w1, b1, w2, b2, eps: float = 1e-5):
    """x (..., d) + MLP(LN(x)); CPU tensors take the plain version, CUDA
    tensors launch the Hopper kernels or raise: contiguous, 32-byte aligned
    bf16 operands, and the widths the C entry `wtt_encoder_mlp` takes (d a
    Whisper width from 256 to 1280, h a multiple of 256), which it checks
    itself. One call is three launches (LN, GEMM1, GEMM2), counted once in
    `.launches`."""
    if x.device.type == "cpu":
        return fused_mlp_block_plain(x, ln_g, ln_b, w1, b1, w2, b2, eps)
    refuse_grad("fused_mlp_block", x, ln_g, ln_b, w1, b1, w2, b2)
    lead, d = x.shape[:-1], x.shape[-1]
    h = w1.shape[-1]
    if w1.shape != (d, h) or w2.shape != (h, d):
        raise ValueError(f"fused MLP weights {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)} do not fit x (..., {d})")
    args = [x.reshape(-1, d).contiguous(), ln_g, ln_b, w1, b1, w2, b2]
    for t in args:
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.data_ptr() % 32:
            raise ValueError("fused MLP operands must be contiguous, 32-byte "
                             "aligned bf16 tensors")
    x2 = args[0]
    m = x2.shape[0]
    out = torch.empty_like(x2)
    hn = torch.empty_like(x2)
    hidden = torch.empty((m, h), dtype=torch.bfloat16, device=x.device)
    err = library().wtt_encoder_mlp(
        *(t.data_ptr() for t in args), out.data_ptr(), hn.data_ptr(),
        hidden.data_ptr(), m, d, h,
        plan_ksplit(m, d, _sm_count(x.get_device())), float(eps),
        stream_ptr(x))
    check(err, "wtt_encoder_mlp")
    fused_mlp_block.launches += 1
    return out.reshape(*lead, d)


fused_mlp_block.launches = 0
