"""Operations and bytes of each kernel family and of the model, from
shapes, and the card's published peaks: the yardstick of the roofline and
utilisation metrics.

A kernel's bytes count each input byte read once and each output byte
written once, whatever the kernel reads again; where the work depends on
the data (which beam lanes share a parent), the least these inputs need.
A bound is the larger of bytes over the memory rate and operations over
the peak rate. The formulas are those of chip_smoke.py's kernel phase
(its `bound` and each kernel's work tuple), frozen here.
"""

from __future__ import annotations

import math
from typing import Iterable, Tuple

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate and HBM3 rate,
# at the full 700 W power limit.
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

Work = Tuple[float, float]  # (bytes, operations)


def bound_s(work: Work) -> float:
    """Least seconds on the card for (bytes, bf16 operations)."""
    n_bytes, flops = work
    return max(n_bytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def flash_attention(b: int, sq: int, sk: int, d: int, elem: int = 2) -> Work:
    """K1: q (b, sq, d), k and v (b, sk, d) read, out (b, sq, d) written;
    QK^T and PV over every pair (the encoder's attention is not causal)."""
    return ((2 * b * sq * d + 2 * b * sk * d) * elem, 4 * b * sq * sk * d)


def encoder_mlp(m: int, d: int, hidden: int, elem: int = 2) -> Work:
    """K2: LayerNorm + GEMM + bias + GELU + GEMM + bias + residual over m
    rows: x read and out written, both weights, both biases and the LN
    affine read once."""
    return ((2 * m * d + 2 * d * hidden + hidden + 3 * d) * elem,
            4 * m * d * hidden)


def decode_self(visible: Iterable[int], d: int, elem: int = 2) -> Work:
    """K3 over a self cache, one S = 1 query per lane: lane i reads its
    K and V rows [0, pos], visible[i] = pos + 1 of them; q read, out
    written, one int position a lane."""
    visible = list(visible)
    b = len(visible)
    read = sum(2 * n * d * elem for n in visible)
    return (read + 2 * b * d * elem + 4 * b, sum(4 * n * d for n in visible))


def decode_cross(lanes: int, windows: int, sa: int, d: int,
                 elem: int = 2) -> Work:
    """K3 (one lane a window) or K3g (lanes / windows lanes a window)
    over a cross cache: each window's K and V rows read once, every lane's
    q read and out written; every lane attends all sa rows."""
    return (2 * windows * sa * d * elem + 2 * lanes * d * elem + 4 * lanes,
            4 * lanes * sa * d)


def permute(lanes: int, windows: int, layers: int, rows: int, d: int,
            arrays: int = 2, elem: int = 2) -> Work:
    """K4, the beam reshuffle of `arrays` self caches: the valid rows
    [0, rows) of each layer of each lane's parent slab read, every lane's
    written. Which lanes share a parent depends on the data; the least a
    window can read is one parent, so the bytes count `windows` slabs
    read and `lanes` written."""
    return (arrays * (windows + lanes) * layers * rows * d * elem, 0.0)


# -- the model, per window ---------------------------------------------------

def encoder_flops(frames: int, n_mels: int, d: int, layers: int,
                  ffn: int) -> float:
    """Multiply-adds x 2 of the encoder over one window of `frames` mel
    frames: the two convolutions (kernel 3; the second of stride 2), then
    per layer QKV, attention, output and the MLP at S = ceil(frames / 2)."""
    s = math.ceil(frames / 2)
    conv = 2 * 3 * frames * n_mels * d + 2 * 3 * s * d * d
    return conv + layers * (8 * s * d * d + 4 * s * s * d + 4 * s * d * ffn)


def cross_kv_flops(sa: int, d: int, layers: int) -> float:
    """The cross K and V projections of one window, every decoder layer."""
    return layers * 4 * sa * d * d


def decoder_position_flops(pos: int, sa: int, d: int, layers: int, ffn: int,
                           vocab: int) -> float:
    """One decoder position at `pos` (it attends pos + 1 self rows and sa
    cross rows), every layer, and its logits over the vocabulary."""
    per_layer = (8 * d * d + 4 * (pos + 1) * d  # self QKV, out; attention
                 + 4 * d * d + 4 * sa * d  # cross q, out; attention
                 + 4 * d * ffn)  # MLP
    return layers * per_layer + 2 * d * vocab


def window_flops(frames: int, prompt: int, depth: int, lanes: int,
                 cfg: dict) -> float:
    """Useful operations of one decoded window: its encoder pass, its
    cross K/V, the prompt's positions once, and `depth - 1` S = 1 steps
    for each of `lanes` lanes (the last token comes from the step before)."""
    d, v = cfg["d_model"], cfg["vocab_size"]
    dl, ffn = cfg["decoder_layers"], cfg["decoder_ffn_dim"]
    sa = math.ceil(frames / 2)
    total = encoder_flops(frames, cfg["num_mel_bins"], d,
                          cfg["encoder_layers"], cfg["encoder_ffn_dim"])
    total += cross_kv_flops(sa, d, dl)
    total += sum(decoder_position_flops(p, sa, d, dl, ffn, v)
                 for p in range(prompt))
    total += lanes * sum(decoder_position_flops(p, sa, d, dl, ffn, v)
                         for p in range(prompt, prompt + depth - 1))
    return total


def window_frames(n_samples: int, n_audio_ctx: int, padding: int) -> int:
    """Mel frames the encoder takes for a window of n_samples: one frame
    every 160 samples (the last dropped), at most n_audio_ctx - padding,
    plus the padding."""
    return min(n_samples // 160, n_audio_ctx - padding) + padding
