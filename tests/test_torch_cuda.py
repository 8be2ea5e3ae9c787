"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked `cuda`: they need an NVIDIA Hopper GPU and nvcc, and skip elsewhere
(the decision is made inside the fixture, never at import). Run them on the
card with `python -m pytest tests/test_torch_cuda.py -q`. The tolerances
are the ones each kernel module states; chip_smoke.py holds the same
kernels at the full large-v2 shapes.
"""

import copy
import dataclasses
import os
import wave as wave_mod

import numpy as np
import pytest
import torch

from whisper_tpu_torch import cli as torch_cli
from whisper_tpu_torch.decode.step_graphs import STEP_GRAPHS
from whisper_tpu_torch.models import whisper as M
from whisper_tpu_torch.ops.kernels import decode_attention as KC
from whisper_tpu_torch.ops.kernels import encoder_block as KB
from whisper_tpu_torch.ops.kernels import flash_attention as KA
from whisper_tpu_torch.ops.kernels import permute as KP
from whisper_tpu_torch.ops.kernels import permute_attention as KF
from whisper_tpu_torch.quantize import pack_int4

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def no_held_step_graphs():
    """Each test starts and ends with no captured greedy step: a replay of
    a graph held from an earlier test runs no kernel wrapper, so a test's
    launch counts would depend on the tests run before it."""
    STEP_GRAPHS.clear()
    yield
    STEP_GRAPHS.clear()


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(shape, gen, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def _close(got, want, atol, rtol):
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


# (Sq, Sk, causal): the encoder's windows (S = 750, and 705 with 63 of the
# last 128-key tile padded), the 4-window batch's length, a q-tile that is
# almost all padding (Sq = 4 against 1500 keys), causal squares that end
# inside a tile, and a ragged small case.
FLASH_SHAPES = [(750, 750, False), (705, 705, False), (1500, 1500, False),
                (4, 1500, False), (130, 130, True), (224, 224, True),
                (3, 77, False)]


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("sq,sk,causal", FLASH_SHAPES)
def test_flash_attention_kernel(gen, b, sq, sk, causal):
    """K1 on q/k/v that are the strided slices of one fused (B, S, 3, d)
    projection (separate tensors where Sq != Sk). v of mean 1: |out| near
    1, so keys past Sk leaking into the softmax would shrink it well past
    the tolerance."""
    heads, d = 4, 256
    if sq == sk:
        qkv = _randn((b, sq, 3, d), gen)
        qkv[:, :, 2] += 1
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q, k = _randn((b, sq, d), gen), _randn((b, sk, d), gen)
        v = _randn((b, sk, d), gen) + 1
    before = KA.attention_bhsd.launches
    got = KA.attention_bhsd(q, k, v, heads, causal=causal)
    assert KA.attention_bhsd.launches == before + 1
    _close(got, KA.attention_bhsd_plain(q, k, v, heads, causal=causal),
           KA.ATOL, KA.RTOL)


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("sq,sk,causal", FLASH_SHAPES)
def test_legacy_flash_attention_kernel(gen, b, sq, sk, causal):
    """K9 on (B, H, S, hd) views of (B, S, H, hd) projections (q
    pre-scaled), and through attention_bhsd(impl="legacy")."""
    q = _randn((b, sq, 4, 64), gen, 0.125).transpose(1, 2)
    k = _randn((b, sk, 4, 64), gen).transpose(1, 2)
    v = (_randn((b, sk, 4, 64), gen) + 1).transpose(1, 2)
    before = KA.flash_attention.launches
    got = KA.flash_attention(q, k, v, causal)
    assert KA.flash_attention.launches == before + 1
    assert got.shape == (b, 4, sq, 64) and got.dtype == torch.bfloat16
    _close(got, KA.flash_attention_plain(q, k, v, causal), KA.ATOL, KA.RTOL)
    x = _randn((b, sq, 256), gen)
    kv = _randn((b, sk, 256), gen)
    before_k1 = KA.attention_bhsd.launches
    got = KA.attention_bhsd(x, kv, kv + 1, 4, causal=causal, impl="legacy")
    assert KA.flash_attention.launches == before + 2
    assert KA.attention_bhsd.launches == before_k1
    _close(got, KA.attention_bhsd_plain(x, kv, kv + 1, 4, causal=causal),
           KA.ATOL, KA.RTOL)
    with pytest.raises(TypeError, match="bfloat16"):
        KA.flash_attention(q.float(), k.float(), v.float())


@pytest.mark.parametrize("c", [50, 750])
@pytest.mark.parametrize("storage", ["bf16", "f32", "int8", "int4"])
def test_flat_decode_attention_kernel(gen, storage, c):
    """K8 on one layer sliced out of a stacked (B, L, C, d) buffer, per-row
    pos; counted apart from K3. C = 750 takes the split kernel (a cluster
    over the rows of the one-layer view). A view without 16-byte aligned
    rows raises ValueError instead of falling back."""
    b, d = 3, 128
    lim = {"int8": 127, "int4": 7}.get(storage)
    if lim is None:
        dt = torch.float32 if storage == "f32" else torch.bfloat16
        kc, vc = _randn((b, 4, c, d), gen, dtype=dt), _randn((b, 4, c, d), gen,
                                                             dtype=dt)
        q = _randn((b, d), gen, 0.125, dtype=dt)
    else:
        kc, vc = (torch.randint(-lim, lim + 1, (b, 4, c, d), generator=gen,
                                device="cuda", dtype=torch.int8)
                  for _ in "kv")
        q = _randn((b, d), gen, 0.5 / lim)
        if storage == "int4":
            kc, vc = pack_int4(kc), pack_int4(vc)
        dt = torch.bfloat16
    pos = torch.tensor([0, 17, c - 1], dtype=torch.int32, device="cuda")
    before = (KC.decode_attention.flat_launches,
              KC.decode_attention_stacked.launches)
    got = KC.decode_attention(q, kc[:, 2], vc[:, 2], pos, 2)
    assert (KC.decode_attention.flat_launches,
            KC.decode_attention_stacked.launches) == (before[0] + 1,
                                                      before[1])
    assert got.dtype == q.dtype
    want = KC.decode_attention_plain(q, kc[:, 2], vc[:, 2], pos, 2)
    _close(got, want, *KC.TOL[dt])
    flat = kc.reshape(-1)
    odd = flat[1:1 + b * c * kc.shape[3]].view(b, c, kc.shape[3])
    with pytest.raises(ValueError, match="16-byte"):
        KC.decode_attention(q, odd, odd, pos, 2)


@pytest.mark.parametrize("m", [1, 37, 63, 64, 65, 705, 750, 3000])
@pytest.mark.parametrize("d", [256, 384, 512, 768, 1024, 1280])
def test_encoder_mlp_kernel(gen, d, m):
    """K2 at every Whisper width (h = 4d), at ragged row counts around a
    64-row consumer tile, at a clip window's 705 rows, one window's 750
    (GEMM2 split over K in a cluster of 2) and four windows' 3000 (no
    split); weights at the init scale."""
    h = 4 * d
    args = (_randn((m, d), gen), _randn((d,), gen, 0.1) + 1,
            _randn((d,), gen, 0.1), _randn((d, h), gen, d ** -0.5),
            _randn((h,), gen, 0.05), _randn((h, d), gen, h ** -0.5),
            _randn((d,), gen, 0.05))
    before = KB.fused_mlp_block.launches
    got = KB.fused_mlp_block(*args)
    assert KB.fused_mlp_block.launches == before + 1
    _close(got, KB.fused_mlp_block_plain(*args), KB.ATOL, KB.RTOL)


@pytest.mark.parametrize("storage", ["bf16", "f32", "int8", "int4"])
@pytest.mark.parametrize("sa", [1, 7, 192, 750, 1500, 3000])
@pytest.mark.parametrize("b", [1, 4, 8])
def test_decode_attention_lane_split_kernel(gen, b, sa, storage):
    """K3 per lane over a layer-major cross cache at the planner's cluster
    size (4 heads: one block below 512 rows, a cluster of 8 above), every
    row visible but for lane 0 (pos 0); counted in `.launches` and
    `.cross_launches`."""
    n_layer, d = 3, 256
    shape = (n_layer, b, sa, d)
    lim = {"int8": 127, "int4": 7}.get(storage)
    if lim is None:
        dt = torch.float32 if storage == "f32" else torch.bfloat16
        kc = _randn(shape, gen, dtype=dt)
        vc = (_randn(shape, gen) + 1).to(dt)
        q = _randn((b, d), gen, 0.125, dtype=dt)
        atol, rtol = KC.TOL[dt]
    else:
        kc = torch.randint(-lim, lim + 1, shape, generator=gen, device="cuda",
                           dtype=torch.int8)
        vc = torch.randint(0, lim + 1, shape, generator=gen, device="cuda",
                           dtype=torch.int8)
        if storage == "int4":
            kc, vc = pack_int4(kc), pack_int4(vc)
        q = _randn((b, d), gen, 0.5 / lim)
        atol, rtol = KC.TOL[torch.bfloat16]
    pos = torch.full((b,), sa - 1, dtype=torch.int32, device="cuda")
    pos[0] = 0
    before = (KC.decode_attention_stacked.launches,
              KC.decode_attention_stacked.cross_launches)
    got = KC.decode_attention_stacked(q, kc, vc, pos, 1, 4)
    assert (KC.decode_attention_stacked.launches,
            KC.decode_attention_stacked.cross_launches) == (before[0] + 1,
                                                            before[1] + 1)
    want = KC.decode_attention_stacked_plain(q, kc, vc, pos, 1, 4)
    _close(got, want, atol, rtol)


@pytest.mark.parametrize("splits", [None, 1, 2, 4, 8])
@pytest.mark.parametrize("storage", ["bf16", "int8", "int4"])
def test_decode_attention_lane_split_self_cache(gen, splits, storage):
    """K3 per lane over a batch-major self cache read to c_used = 300 of
    448 rows, mixed pos with 0, c_used - 1 and one past c_used (clamped),
    at the planner's and at forced cluster sizes; a bf16 cache's rows past
    c_used hold NaN, which would reach the output if they were read. Not
    counted as cross launches."""
    b, n_layer, c, c_used, d = 5, 2, 448, 300, 256
    shape = (b, n_layer, c, d)
    if storage == "bf16":
        kc, vc = _randn(shape, gen), _randn(shape, gen) + 1
        kc[:, :, c_used:], vc[:, :, c_used:] = float("nan"), float("nan")
        q = _randn((b, d), gen, 0.125)
    else:
        lim = 7 if storage == "int4" else 127
        kc, vc = (torch.randint(-lim, lim + 1, shape, generator=gen,
                                device="cuda", dtype=torch.int8)
                  for _ in "kv")
        if storage == "int4":
            kc, vc = pack_int4(kc), pack_int4(vc)
        q = _randn((b, d), gen, 0.5 / lim)
    pos = torch.tensor([0, 37, c_used - 1, c_used, 150], dtype=torch.int32,
                       device="cuda")
    before = KC.decode_attention_stacked.cross_launches
    got = KC.decode_attention_stacked(q, kc, vc, pos, 1, 4, batch_major=True,
                                      c_used=c_used, splits=splits)
    assert KC.decode_attention_stacked.cross_launches == before
    want = KC.decode_attention_stacked_plain(q, kc, vc, pos, 1, 4,
                                             batch_major=True, c_used=c_used)
    _close(got, want, *KC.TOL[torch.bfloat16])


def test_split_kernels_are_deterministic(gen):
    """Two calls give the same bits: K2 with GEMM2 split over K in a
    cluster (M = 750), K3 and K8 split over a cluster (their f32 partials
    are combined in a fixed order, no atomics)."""
    d, h, m = 1280, 5120, 750
    args = (_randn((m, d), gen), _randn((d,), gen, 0.1) + 1,
            _randn((d,), gen, 0.1), _randn((d, h), gen, 0.02),
            _randn((h,), gen, 0.02), _randn((h, d), gen, 0.02),
            _randn((d,), gen, 0.02))
    assert KB.plan_ksplit(m, d, torch.cuda.get_device_properties(0)
                          .multi_processor_count) == 2
    assert torch.equal(KB.fused_mlp_block(*args), KB.fused_mlp_block(*args))
    kc, vc = _randn((4, 1, 750, d), gen), _randn((4, 1, 750, d), gen)
    q = _randn((1, d), gen, 0.125)
    once = KC.decode_attention_stacked(q, kc, vc, 749, 2, 20)
    assert torch.equal(once, KC.decode_attention_stacked(q, kc, vc, 749, 2, 20))
    kq, vq = (torch.randint(-127, 128, (2, 750, d), generator=gen,
                            device="cuda", dtype=torch.int8) for _ in "kv")
    pos = torch.tensor([100, 749], dtype=torch.int32, device="cuda")
    q = _randn((2, d), gen, 0.125)
    assert KC.plan_lane_splits(20, 2, 750) == 8
    twice = [KC.decode_attention(q, kq, vq, pos, 20) for _ in range(2)]
    assert torch.equal(*twice)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batch_major", [True, False])
def test_decode_attention_kernel(gen, dtype, batch_major):
    b, n_layer, c, d = 3, 4, 50, 128
    shape = (b, n_layer, c, d) if batch_major else (n_layer, b, c, d)
    kc, vc = _randn(shape, gen, dtype=dtype), _randn(shape, gen, dtype=dtype)
    q = _randn((b, d), gen, 0.125, dtype=dtype)
    pos = torch.tensor([0, 17, 39], dtype=torch.int32, device="cuda")
    got = KC.decode_attention_stacked(q, kc, vc, pos, 2, 2,
                                      batch_major=batch_major, c_used=40)
    want = KC.decode_attention_stacked_plain(q, kc, vc, pos, 2, 2,
                                             batch_major=batch_major,
                                             c_used=40)
    _close(got, want, *KC.TOL[dtype])


def _ragged_pos(gen, n_q, sa):
    """A pos per q row in [0, sa), the first 0 and the last sa - 1."""
    pos = torch.randint(0, sa, (n_q,), generator=gen, device="cuda",
                        dtype=torch.int32)
    pos[0], pos[-1] = 0, sa - 1
    return pos


# K3g's shapes: R lanes a kv row (one group up to 8, two at 10 and 16), W
# kv rows (windows), Sa rows of cache. With 4 heads the split planner gives
# clusters of 4 blocks (2 at 33 windows; one block, a plain launch, at
# Sa = 1 and 7); Sa = 1500 and 3000 leave each block more rows than one
# 256-row TMA box holds.
GROUP_SHAPES = [(rep, w, sa) for rep in (2, 5, 8, 10, 16) for w in (1, 4)
                for sa in (1, 7, 750, 1500)] + [(5, 33, 1500), (5, 1, 3000)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batch_major", [True, False])
@pytest.mark.parametrize("rep,w,sa", GROUP_SHAPES)
def test_decode_attention_group_kernel(gen, dtype, batch_major, rep, w, sa):
    """K3g: kv row j serves q rows [j*rep, (j+1)*rep), a ragged pos per q
    row (0 included); v of mean 1, so a dropped mask shows."""
    n_layer, d = 2, 256
    shape = (w, n_layer, sa, d) if batch_major else (n_layer, w, sa, d)
    kc = _randn(shape, gen, dtype=dtype)
    vc = (_randn(shape, gen) + 1).to(dtype)
    q = _randn((w * rep, d), gen, 0.125, dtype=dtype)
    pos = _ragged_pos(gen, w * rep, sa)
    before = (KC.decode_attention_stacked.launches,
              KC.decode_attention_stacked.group_launches)
    got = KC.decode_attention_stacked(q, kc, vc, pos, 1, 4,
                                      batch_major=batch_major, kv_rep=rep)
    assert (KC.decode_attention_stacked.launches,
            KC.decode_attention_stacked.group_launches) == (before[0],
                                                            before[1] + 1)
    want = KC.decode_attention_stacked_plain(q, kc, vc, pos, 1, 4,
                                             batch_major=batch_major,
                                             kv_rep=rep)
    _close(got, want, *KC.TOL[dtype])


@pytest.mark.parametrize("storage", ["int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rep,w,sa", [(1, 2, 70)] + GROUP_SHAPES)
def test_decode_attention_integer_cache_kernel(gen, storage, dtype, rep, w,
                                               sa):
    """K3 (rep 1) and K3g over an int8 / packed-int4 layer-major cross
    cache, a ragged pos per q row (0 included); rep 10 and 16 run two
    groups of lanes per kv row."""
    n_layer, d = 2, 256
    lim = 7 if storage == "int4" else 127
    kc, vc = (torch.randint(-lim, lim + 1, (n_layer, w, sa, d), generator=gen,
                            device="cuda", dtype=torch.int8) for _ in "kv")
    if storage == "int4":
        kc, vc = pack_int4(kc), pack_int4(vc)
    q = _randn((w * rep, d), gen, 0.5 / lim, dtype=dtype)
    pos = _ragged_pos(gen, w * rep, sa)
    counter = "launches" if rep == 1 else "group_launches"
    before = getattr(KC.decode_attention_stacked, counter)
    got = KC.decode_attention_stacked(q, kc, vc, pos, 1, 4, kv_rep=rep)
    assert getattr(KC.decode_attention_stacked, counter) == before + 1
    assert got.dtype == dtype
    want = KC.decode_attention_stacked_plain(q, kc, vc, pos, 1, 4,
                                             kv_rep=rep)
    atol, rtol = KC.TOL[dtype]
    _close(got, want, atol * (lim if dtype == torch.float32 else 1), rtol)


@pytest.mark.parametrize("splits", [None, 1, 2, 8])
@pytest.mark.parametrize("storage", ["bf16", "int4"])
@pytest.mark.parametrize("rep,w,c,c_used", [(5, 4, 800, 750), (2, 3, 50, 40)])
def test_decode_attention_group_kernel_c_used(gen, splits, storage, rep, w, c,
                                              c_used):
    """K3g reading only rows [0, c_used) of a longer cache, at the planner's
    cluster size and at forced ones: pos runs from 0 past c_used (clamped
    to its last row), and a bf16 cache's rows past c_used hold NaN, which
    would reach the output if the kernel read them."""
    n_layer, d = 2, 256
    shape = (n_layer, w, c, d)
    if storage == "bf16":
        kc, vc = _randn(shape, gen), _randn(shape, gen) + 1
        kc[:, :, c_used:], vc[:, :, c_used:] = float("nan"), float("nan")
        q = _randn((w * rep, d), gen, 0.125)
    else:
        kc, vc = (pack_int4(torch.randint(-7, 8, shape, generator=gen,
                                          device="cuda", dtype=torch.int8))
                  for _ in "kv")
        q = _randn((w * rep, d), gen, 0.5 / 7)
    pos = _ragged_pos(gen, w * rep, c)
    pos[1], pos[2] = c_used - 1, c_used
    before = KC.decode_attention_stacked.group_launches
    got = KC.decode_attention_stacked(q, kc, vc, pos, 1, 4, kv_rep=rep,
                                      c_used=c_used, splits=splits)
    assert KC.decode_attention_stacked.group_launches == before + 1
    want = KC.decode_attention_stacked_plain(q, kc, vc, pos, 1, 4,
                                             kv_rep=rep, c_used=c_used)
    _close(got, want, *KC.TOL[torch.bfloat16])


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [1, 5, 750])
def test_dequant_matmul_rounds_once_on_the_card(gen, bits, m):
    """`_matmul(int8_impl="xla")` of a bf16 x with an int8 / packed-int4
    QTensor keeps the product in f32 until after the scale: within one
    bf16 step of the f64 product times the scale cast once (plus the f32
    sum's own error bound, K * 2^-24 * sum |terms|, which matters only
    where the terms cancel), and equal to it in more than 98% of the
    elements. The earlier path, the product rounded to bf16 before the
    scale, falls below that share."""
    from whisper_tpu_torch.quantize import QTensor, int_values

    k, n = 1280, 3840
    lim = 2 ** (bits - 1) - 1
    qi = torch.randint(-lim, lim + 1, (k, n), generator=gen, device="cuda",
                       dtype=torch.int8)
    scale = 0.001 + 0.01 * torch.rand(n, generator=gen, device="cuda")
    w = QTensor(pack_int4(qi) if bits == 4 else qi, scale)
    x = _randn((m, k), gen)
    assert torch.equal(int_values(w.q), qi)
    want = ((x.double() @ qi.double()) * scale.double()).bfloat16().float()
    f32_sum = k * 2.0 ** -24 * (x.double().abs() @ qi.double().abs()
                                * scale.double())
    got = M._matmul(x, w, "xla")
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    got = got.float()
    assert bool(((got - want).abs() <= 2 ** -7 * want.abs() + f32_sum).all())
    assert float((got == want).float().mean()) > 0.98
    before = ((x @ qi.bfloat16()).float() * scale).bfloat16().float()
    assert float((before == want).float().mean()) < 0.98


@pytest.mark.parametrize("storage", ["int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_attention_scaled_kernel(gen, dtype, storage):
    """K3s: int8 or packed-int4 batch-major self cache with row scales,
    mixed pos, and a NaN scale on each lane's first masked row."""
    b, n_layer, c, d = 4, 3, 64, 128
    lim = 7 if storage == "int4" else 127
    kc, vc = (torch.randint(-lim, lim + 1, (b, n_layer, c, d), generator=gen,
                            device="cuda", dtype=torch.int8) for _ in "kv")
    if storage == "int4":
        kc, vc = pack_int4(kc), pack_int4(vc)
    ks, vs = (0.01 + 0.04 * torch.rand((b, n_layer, c), generator=gen,
                                       device="cuda") for _ in "kv")
    pos = torch.tensor([0, 9, 40, 62], dtype=torch.int32, device="cuda")
    rows = torch.arange(b, device="cuda")
    ks[rows, 2, pos.long() + 1] = float("nan")
    vs[rows, 2, pos.long() + 1] = float("nan")
    q = _randn((b, d), gen, 0.125, dtype=dtype)
    counter = ("scaled_int4_launches" if storage == "int4"
               else "scaled_launches")
    before = getattr(KC.decode_attention_stacked, counter)
    got = KC.decode_attention_stacked(q, kc, vc, pos, 2, 2, batch_major=True,
                                      k_rowscale=ks, v_rowscale=vs)
    assert getattr(KC.decode_attention_stacked, counter) == before + 1
    want = KC.decode_attention_stacked_plain(q, kc, vc, pos, 2, 2,
                                             batch_major=True, k_rowscale=ks,
                                             v_rowscale=vs)
    assert bool(torch.isfinite(got).all())
    _close(got, want, *KC.TOL[dtype])


@pytest.mark.parametrize("storage", ["int8", "int4"])
@pytest.mark.parametrize("kind", ["random", "collapse", "identity"])
@pytest.mark.parametrize("cow", [True, False])
@pytest.mark.parametrize("per_lane_pos", [False, True])
def test_permute_attention_kernel_bit_equal(gen, kind, cow, per_lane_pos,
                                            storage):
    """K5 against its plain version on the same inputs, int8 or packed
    int4 caches and new rows: the attention output within K3's tolerance,
    every cache and scale array bit-equal: COW dests from `_cow_assign`
    with one int pos (the in-place path), and dests=None or a pos per lane
    (both staged by the wrapper)."""
    from whisper_tpu_torch.decode.beam import _cow_assign

    k, nw, n_layer, c, d = 5, 2, 2, 64, 256
    b = k * nw
    int4 = storage == "int4"
    lim = 7 if int4 else 127

    def ints(shape):
        t = torch.randint(-lim, lim + 1, shape, generator=gen, device="cuda",
                          dtype=torch.int8)
        return pack_int4(t) if int4 else t

    caches = [ints((b, n_layer, c, d)) for _ in "kv"]
    caches += [0.01 + 0.04 * torch.rand((b, n_layer, c), generator=gen,
                                        device="cuda") for _ in "kv"]
    new = [ints((b, d)) for _ in "kv"]
    new += [0.01 + 0.04 * torch.rand(b, generator=gen, device="cuda")
            for _ in "kv"]
    q = _randn((b, d), gen)
    pos = (torch.randint(0, 50, (b,), generator=gen, device="cuda",
                         dtype=torch.int32) if per_lane_pos else 37)
    if kind == "random":
        parent = torch.randint(0, k, (nw, k), generator=gen, device="cuda")
    elif kind == "collapse":
        parent = torch.full((nw, k), 3, device="cuda")
    else:
        parent = torch.arange(k, device="cuda").repeat(nw, 1)
    offs = (torch.arange(nw, device="cuda") * k)[:, None]
    dests = None
    if cow:
        phys = torch.stack([torch.randperm(k, generator=gen, device="cuda")
                            for _ in range(nw)])
        parent, dests = _cow_assign(parent, phys)
        dests = (dests + offs).reshape(b)
    parents = (parent + offs).reshape(b)
    mine = [x.clone() for x in caches]
    counter = "int4_launches" if int4 else "launches"
    before = getattr(KF.decode_attention_permute_fused, counter)
    got = KF.decode_attention_permute_fused(q, *mine, *new, parents, pos, 1,
                                            4, k, dests=dests)
    assert getattr(KF.decode_attention_permute_fused, counter) == before + 1
    plain = [x.clone() for x in caches]
    want = KF.decode_attention_permute_fused_plain(q, *plain, *new, parents,
                                                   pos, 1, 4, k, dests=dests)
    _close(got[0], want[0], *KC.TOL[torch.bfloat16])
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("storage", ["int8", "int4"])
@pytest.mark.parametrize("b", [5, 10])
@pytest.mark.parametrize("kind", ["random", "collapse", "identity"])
@pytest.mark.parametrize("pos", [0, 447])
def test_permute_attention_kernel_at_the_cache_edges(gen, pos, kind, b,
                                                     storage):
    """K5 at the large-v2 width (20 heads) over a 448-row cache, at the
    first row (pos = 0: only the new row is visible) and the last (pos =
    447: every row, the most shared memory a block takes), beam 5 over one
    window or two, COW dests from `_cow_assign` passed as the step passes
    them (int64) and an int pos: the attention within K3's tolerance and
    every cache and scale array bit-equal to the plain version."""
    from whisper_tpu_torch.decode.beam import _cow_assign

    k, n_layer, c, d = 5, 2, 448, 1280
    nw = b // k
    int4 = storage == "int4"
    lim = 7 if int4 else 127

    def ints(shape):
        t = torch.randint(-lim, lim + 1, shape, generator=gen, device="cuda",
                          dtype=torch.int8)
        return pack_int4(t) if int4 else t

    caches = [ints((b, n_layer, c, d)) for _ in "kv"]
    caches += [0.002 + 0.01 * torch.rand((b, n_layer, c), generator=gen,
                                         device="cuda") for _ in "kv"]
    new = [ints((b, d)) for _ in "kv"]
    new += [0.002 + 0.01 * torch.rand(b, generator=gen, device="cuda")
            for _ in "kv"]
    q = _randn((b, d), gen, 0.125)
    parent = {"random": torch.randint(0, k, (nw, k), generator=gen,
                                      device="cuda"),
              "collapse": torch.full((nw, k), 1, device="cuda"),
              "identity": torch.arange(k, device="cuda").repeat(nw, 1)}[kind]
    phys = torch.stack([torch.randperm(k, generator=gen, device="cuda")
                        for _ in range(nw)])
    src, dest = _cow_assign(parent, phys)
    offs = (torch.arange(nw, device="cuda") * k)[:, None]
    parents, dests = (src + offs).reshape(b), (dest + offs).reshape(b)
    mine = [x.clone() for x in caches]
    plain = [x.clone() for x in caches]
    counter = "int4_launches" if int4 else "launches"
    before = getattr(KF.decode_attention_permute_fused, counter)
    got = KF.decode_attention_permute_fused(q, *mine, *new, parents, pos, 1,
                                            20, k, dests=dests)
    assert getattr(KF.decode_attention_permute_fused, counter) == before + 1
    want = KF.decode_attention_permute_fused_plain(q, *plain, *new, parents,
                                                   pos, 1, 20, k, dests=dests)
    _close(got[0], want[0], *KC.TOL[torch.bfloat16])
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("valid_len", [None, 37, 64])
def test_permute_kernel_bit_exact(gen, valid_len):
    """K4, whole slabs and the prefix mode (2 rank-4 caches + 2 rank-3
    per-row arrays, copied whole); rows the prefix mode skips keep the
    out buffer's old values."""
    b, n_layer, c, d = 6, 3, 64, 128
    arrays = [_randn((b, n_layer, c, d), gen) for _ in range(2)]
    arrays += [_randn((b, n_layer, c), gen, dtype=torch.float32)
               for _ in range(2)]
    out = [torch.full_like(a, 3.0) for a in arrays]
    parents = torch.tensor([1, 1, 0, 5, 2, 2], dtype=torch.int32,
                           device="cuda")
    before = KP.permute_lanes_arrays.launches
    KP.permute_lanes_arrays(arrays, parents, out, valid_len=valid_len)
    assert KP.permute_lanes_arrays.launches == before + 1
    torch.cuda.synchronize()
    idx = parents.long()
    rows = c if valid_len is None else -(-valid_len // 32) * 32
    for a, o in zip(arrays, out):
        if a.dim() == 4:
            assert torch.equal(o[:, :, :rows], a[idx][:, :, :rows])
            assert bool((o[:, :, rows:] == 3.0).all())
        else:
            assert torch.equal(o, a[idx])


def _w8a8_edge_rows(k):
    """(2, k) f32: a zero row and a row of exact half quantization steps
    (absmax 127, so the scale is 1)."""
    x = torch.zeros((2, k), device="cuda")
    x[1, 0] = 127.0
    x[1, 1:41] = torch.arange(40, device="cuda") + 0.5
    return x


def _w8a8_operands(gen, m, k, n, dtype, bits=8):
    """x of normal rows, the first two `_w8a8_edge_rows` from three rows
    on (at one or two rows every row is a normal one: a zero row alone
    gives a zero output whatever the weights), int8 weights (bits=4:
    values in [-7, 7], packed to (k, n / 2) uint8), f32 column scales."""
    x = _randn((m, k), gen, dtype=torch.float32)
    if m > 2:
        x[:2] = _w8a8_edge_rows(k)
    lim = 2 ** (bits - 1) - 1
    wq = torch.randint(-lim, lim + 1, (k, n), generator=gen, device="cuda",
                       dtype=torch.int8)
    scale = 0.001 + 0.01 * torch.rand(n, generator=gen, device="cuda")
    return x.to(dtype), pack_int4(wq) if bits == 4 else wq, scale


def _w8a8_counter(wq):
    return "int4_launches" if wq.dtype == torch.uint8 else "launches"


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(1, 256, 384), (5, 1280, 256),
                                   (20, 512, 128), (70, 256, 256),
                                   (300, 384, 640)])
def test_w8a8_small_kernel_bit_equal(gen, dtype, m, k, n, bits):
    """K6 at decode rows (the 16-row tiles) and past 64 rows (the 128 x 128
    tiles), bf16 and f32 x, int8 and packed-int4 weights: bit-equal to its
    plain version (and, for int4, to the int8 kernel over the unpacked
    weight)."""
    from whisper_tpu_torch.ops.kernels import dequant_matmul as KQ
    from whisper_tpu_torch.quantize import int_values

    x, wq, scale = _w8a8_operands(gen, m, k, n, dtype, bits)
    counter = _w8a8_counter(wq)
    before = getattr(KQ.quantized_matmul, counter)
    got = KQ.quantized_matmul(x, wq, scale)
    assert getattr(KQ.quantized_matmul, counter) == before + 1
    assert got.dtype == dtype and got.shape == (m, n)
    torch.cuda.synchronize()
    assert torch.equal(got, KQ.quantized_matmul_plain(x, wq, scale))
    if bits == 4:
        assert torch.equal(got, KQ.quantized_matmul(x, int_values(wq), scale))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [10, 1025, 1537])
def test_w8a8_big_kernel_bit_equal(gen, dtype, m, bits):
    """K7's rounding in the small-M kernel (10 rows) and with a ragged last
    row tile, int8 and packed-int4 weights: bit-equal to its plain
    version."""
    from whisper_tpu_torch.ops.kernels import dequant_matmul as KQ

    x, wq, scale = _w8a8_operands(gen, m, 640, 384, dtype, bits)
    counter = _w8a8_counter(wq)
    before = getattr(KQ.quantized_matmul_big, counter)
    got = KQ.quantized_matmul_big(x, wq, scale)
    assert getattr(KQ.quantized_matmul_big, counter) == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, KQ.quantized_matmul_big_plain(x, wq, scale))
    f32 = KQ.quantized_matmul_big(x, wq, scale, out_dtype=torch.float32)
    assert torch.equal(f32, KQ.quantized_matmul_big_plain(
        x, wq, scale, out_dtype=torch.float32))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("n", [128, 1280, 3840])
@pytest.mark.parametrize("m", [1, 5, 16, 17, 20, 64])
@pytest.mark.parametrize("k", [128, 1280, 5120])
def test_w8a8_split_kernel_bit_equal_at_the_edges(gen, k, m, n, bits):
    """K6's one-launch split-K kernel at the edges of its plan (K of 4, 40
    and 160 steps of 32; row tiles of 8 and the 32-row chunks: M = 1, 5,
    16, 17, 20 and 64; one, ten and thirty 128-column tiles), over normal
    rows and (from M = 5, and at M = 1 as x's of their own) a zero row and
    a row of exact half steps: bit-equal to the plain version under
    `plan_small`'s plan and under every other split the kernel takes
    (each cluster size), with the rows' absmax exchanged in the cluster
    and read whole by every block (where whole rows fit), and with an x
    whose storage is not 16-byte aligned (the wrapper copies it)."""
    from whisper_tpu_torch.ops.kernels import dequant_matmul as KQ

    x, wq, scale = _w8a8_operands(gen, m, k, n, torch.bfloat16, bits)
    want = KQ.quantized_matmul_plain(x, wq, scale)
    assert want.abs().amax() > 0
    steps = k // 32
    splits = [s for s in range(1, KQ.MAX_KSPLIT + 1)
              if steps % s == 0 and k // s <= KQ.MAX_SLICE]
    wholes = (False, True) if m * k * 2 <= 65536 else (False,)
    edges = ([] if m > 2 else
             list(_w8a8_edge_rows(k).bfloat16().split(1)))
    for plan in [None] + [(s, w) for s in splits for w in wholes]:
        got = KQ.quantized_matmul(x, wq, scale, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(got, want), plan
        for row in edges:
            assert torch.equal(KQ.quantized_matmul(row, wq, scale, plan=plan),
                               KQ.quantized_matmul_plain(row, wq, scale)), plan
    odd = torch.empty(m * k + 1, dtype=x.dtype, device="cuda")[1:].view(m, k)
    odd.copy_(x)
    assert odd.data_ptr() % 16
    assert torch.equal(KQ.quantized_matmul(odd, wq, scale), want)


def _kernel_names(fn):
    """{kernel name: launches} of one call of fn on the card (a first,
    empty profiling session warms the tracer up). Called only in a
    process of its own (`_in_own_process`)."""
    from torch.profiler import ProfilerActivity, profile

    counts = {}
    for run in (False, True):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if run:
                fn()
            torch.cuda.synchronize()
        counts = {e.key: e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA}
    return counts


def _in_own_process(check):
    """Runs `check(gen)`, a function of this module, in a fresh Python
    process and fails with its output if it fails. The profiler's CUDA
    events are then counted whatever earlier tests left in this process's
    tracer: run after the CLI tests, a profiling session here recorded no
    CUDA events at all, warm-up session or not."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH"))
                           if p)
    run = subprocess.run([sys.executable, os.path.abspath(__file__),
                          check.__name__], cwd=root, capture_output=True,
                         text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=path))
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-6000:]


def test_k6_and_k5_calls_are_one_launch_each(gen):
    """One K6 call at decode rows launches exactly one kernel, and so does
    one K5 call on the in-place path; in a W8A8 beam decoder step every K6
    and K5 call is one kernel (`_check_k6_and_k5_launches`, in a process
    of its own)."""
    _in_own_process(_check_k6_and_k5_launches)


def _check_k6_and_k5_launches(gen):
    """One K6 call at decode rows launches exactly one kernel (the split
    GEMM, no row-quantize pass), and so does one K5 call on the in-place
    path with `_cow_assign`'s int64 parents and dests and an int pos; in a
    W8A8 beam decoder step over an int8 self cache every K6 call and every
    K5 call is one kernel and nothing converts the indices."""
    import dataclasses

    from whisper_tpu_torch.config import KernelKnobs, tiny_test_config
    from whisper_tpu_torch.decode.beam import _cow_assign
    from whisper_tpu_torch.ops.kernels import dequant_matmul as KQ
    from whisper_tpu_torch.params import init_params
    from whisper_tpu_torch.quantize import quantize_params

    x, wq, scale = _w8a8_operands(gen, 5, 1280, 3840, torch.bfloat16)
    KQ.quantized_matmul(x, wq, scale)  # builds the library
    names = _kernel_names(lambda: KQ.quantized_matmul(x, wq, scale))
    assert len(names) == 1 and sum(names.values()) == 1, names
    assert "gemm_splitk_kernel" in next(iter(names)), names

    k, d, c = 5, 256, 64
    caches = [torch.randint(-127, 128, (k, 2, c, d), generator=gen,
                            device="cuda", dtype=torch.int8) for _ in "kv"]
    caches += [0.01 + 0.04 * torch.rand((k, 2, c), generator=gen,
                                        device="cuda") for _ in "kv"]
    new = [caches[0][:, 0, 0].clone(), caches[1][:, 0, 0].clone(),
           caches[2][:, 0, 0].clone(), caches[3][:, 0, 0].clone()]
    parent = torch.randint(0, k, (1, k), generator=gen, device="cuda")
    src, dest = _cow_assign(parent, torch.randperm(
        k, generator=gen, device="cuda")[None])
    assert src.dtype == torch.int64
    q = _randn((k, d), gen)
    names = _kernel_names(lambda: KF.decode_attention_permute_fused(
        q, *caches, *new, src[0], 37, 1, 4, k, dests=dest[0]))
    assert len(names) == 1 and sum(names.values()) == 1, names
    assert "permute_attention_kernel" in next(iter(names)), names

    cfg = tiny_test_config(n_state=256, n_head=4, n_layer=2, n_vocab=128,
                           n_audio_ctx=96, n_text_ctx=48)
    w8a8 = dataclasses.replace(cfg, attention="flash",
                               knobs=KernelKnobs(int8_impl="pallas"))
    params = quantize_params(init_params(cfg, gen, dtype=torch.bfloat16),
                             bits=8)
    enc = _randn((1, 48, 256), gen)
    cache = M.init_cache(params, enc, w8a8, batch=k, kv_quant="int4",
                         self_quant=True)
    _, cache = M.decoder_step(params, torch.ones((k, 3), dtype=torch.long,
                                                 device="cuda"), 0, cache,
                              w8a8)
    tok = torch.ones((k, 1), dtype=torch.long, device="cuda")
    before = (KQ.quantized_matmul.launches,
              KF.decode_attention_permute_fused.launches)
    names = _kernel_names(lambda: M.decoder_step(
        params, tok, 3, cache, w8a8, parents=src[0], dests=dest[0]))
    k6 = KQ.quantized_matmul.launches - before[0]
    k5 = KF.decode_attention_permute_fused.launches - before[1]
    assert k6 == 6 * 2 and k5 == 2

    def launched(part):
        return sum(c for n, c in names.items() if part in n)

    assert launched("gemm_splitk_kernel") == k6
    assert launched("prep_kernel") == 0
    assert launched("permute_attention_kernel") == k5


def test_one_block_and_big_route_launches(gen):
    """One call of the self-cache kernel is one launch, one call of the
    large-M route two (`_check_one_block_and_big_route_launches`, in a
    process of its own)."""
    _in_own_process(_check_one_block_and_big_route_launches)


def _check_one_block_and_big_route_launches(gen):
    """One call of the self-cache kernel is one launch (K3 over a bf16
    self cache, K3s over int8 and int4 ones); one call of the large-M
    route is two (the prep pass and the tile kernel), for K6 at 750 rows
    (counted in `tile_launches` too) and K7 at 1537: launch counters and
    profiler events agree."""
    from whisper_tpu_torch.ops.kernels import dequant_matmul as KQ

    for storage, scaled in (("bf16", False), ("int8", True), ("int4", True)):
        q, kc, vc, pos, scales = _one_block_operands(
            gen, storage, torch.bfloat16, scaled, (5, 3, 128, 1280),
            [40] * 5)
        call = lambda: KC.decode_attention_stacked(  # noqa: E731
            q, kc, vc, pos, 2, 20, batch_major=True, **scales)
        call()
        names = _kernel_names(call)
        assert len(names) == 1 and sum(names.values()) == 1, names
        assert "decode_attention_kernel" in next(iter(names)), names
    for m, fn in ((750, KQ.quantized_matmul), (1537, KQ.quantized_matmul_big)):
        x, wq, scale = _w8a8_operands(gen, m, 1280, 3840, torch.bfloat16)
        before = (fn.launches, KQ.quantized_matmul.tile_launches)
        fn(x, wq, scale)
        assert (fn.launches, KQ.quantized_matmul.tile_launches) == (
            before[0] + 1, before[1] + (fn is KQ.quantized_matmul))
        names = _kernel_names(lambda: fn(x, wq, scale))
        assert sum(names.values()) == 2, names
        assert sum(c for n, c in names.items() if "gemm_big_kernel" in n) == 1
        assert sum(c for n, c in names.items() if "prep_kernel" in n) == 1


def test_w8a8_wrappers_raise_on_what_they_do_not_take(gen):
    from whisper_tpu_torch.ops.kernels import dequant_matmul as KQ
    from whisper_tpu_torch.quantize import pack_int4

    x, wq, scale = _w8a8_operands(gen, 4, 256, 256, torch.bfloat16)
    with pytest.raises(TypeError, match="int8 or packed-int4"):
        KQ.quantized_matmul(x, wq.to(torch.int16), scale)
    with pytest.raises(ValueError, match="scales"):  # packed N 512 != 256
        KQ.quantized_matmul(x, pack_int4(torch.zeros(
            (256, 512), dtype=torch.int8, device="cuda")), scale)
    with pytest.raises(ValueError, match="multiples of 128"):
        KQ.quantized_matmul(x[:, :200], wq[:200], scale)
    with pytest.raises(ValueError, match="contiguous"):
        KQ.quantized_matmul_big(x.t().contiguous().t(), wq, scale)
    with pytest.raises(TypeError, match="bf16/f32"):
        KQ.quantized_matmul(x.half(), wq, scale)


def test_cuda_wrappers_raise_instead_of_falling_back(gen):
    x = _randn((1, 8, 96), gen)  # head dim 48: no kernel for it
    with pytest.raises(ValueError, match="head dim"):
        KA.attention_bhsd(x, x, x, 2)
    with pytest.raises(ValueError, match="shapes the kernel does not take"):
        KB.fused_mlp_block(x, x[0, 0], x[0, 0], _randn((96, 384), gen),
                           _randn((384,), gen), _randn((384, 96), gen),
                           x[0, 0])
    y = _randn((40 * 96 + 8,), gen)[8:].view(40, 96)  # 16-byte, not 32
    with pytest.raises(ValueError, match="32-byte"):
        KB.fused_mlp_block(y, y[0], y[0], _randn((96, 384), gen),
                           _randn((384,), gen), _randn((384, 96), gen), y[0])
    kc = _randn((2, 1, 16, 128), gen)
    with pytest.raises(ValueError, match="kv_rep"):  # 18 q rows, 2 kv rows
        KC.decode_attention_stacked(_randn((18, 128), gen), kc, kc, 3, 0, 2,
                                    kv_rep=4)
    with pytest.raises(ValueError, match="splits"):  # clusters of 1..8
        KC.decode_attention_stacked(_randn((1, 128), gen), kc, kc, 3, 0, 2,
                                    splits=16)
    # row scales (K3s) take the one-block kernel only
    kq = torch.zeros((2, 1, 16, 128), dtype=torch.int8, device="cuda")
    rs = torch.ones((2, 1, 16), device="cuda")
    with pytest.raises(ValueError, match="one-block"):
        KC.decode_attention_stacked(_randn((2, 128), gen), kq, kq, 3, 0, 2,
                                    batch_major=True, k_rowscale=rs,
                                    v_rowscale=rs, splits=4)
    # the split kernel's TMA maps need 16-byte aligned rows and base: a
    # cache that starts 2 bytes in is refused, never read another way
    flat = _randn((2 * 800 * 128 + 1,), gen)
    odd = flat[1:].view(2, 1, 800, 128)
    with pytest.raises(ValueError, match="16-byte"):
        KC.decode_attention_stacked(_randn((1, 128), gen), odd, odd, 799, 0,
                                    2, splits=4)
    par = torch.zeros(2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="overlaps"):
        KP.permute_lanes_arrays((kc,), par, (kc,))
    odd = _randn((2, 1, 16, 4), gen)  # 8-byte rows: no 16-byte vectors
    with pytest.raises(ValueError, match="16 bytes"):
        KP.permute_lanes_arrays((odd,), par, (torch.empty_like(odd),),
                                valid_len=3, chunk=1)


def test_encoder_block_never_runs_the_plain_mlp_on_the_card(gen):
    """d = 192 (3 heads of 64) has a flash kernel but no fused-MLP width:
    the flash encoder block raises instead of running the plain MLP."""
    d = 192
    p = {"attn_ln_g": _randn((d,), gen) + 1, "attn_ln_b": _randn((d,), gen),
         "qkv_w": _randn((d, 3, d), gen, 0.05), "qkv_b": _randn((3, d), gen),
         "attn_o_w": _randn((d, d), gen, 0.05), "attn_o_b": _randn((d,), gen),
         "mlp_ln_g": _randn((d,), gen) + 1, "mlp_ln_b": _randn((d,), gen),
         "mlp1_w": _randn((d, 4 * d), gen, 0.05),
         "mlp1_b": _randn((4 * d,), gen), "mlp2_w": _randn((4 * d, d), gen,
                                                           0.05),
         "mlp2_b": _randn((d,), gen)}
    before = KA.attention_bhsd.launches
    with pytest.raises(ValueError, match="wtt_encoder_mlp"):
        M._encoder_block(_randn((1, 40, d), gen), p, 3, 1e-5, "flash")
    assert KA.attention_bhsd.launches == before + 1


@pytest.fixture(scope="module")
def cli_dir(tmp_path_factory):
    """A 2 + 2-layer random checkpoint at kernel widths (d 256, 4 heads of
    64) with ~0.87 s windows, the synthetic tokenizer and 2.3 s of audio."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import jax

    from whisper_tpu.config import tiny_test_config
    from whisper_tpu.io import npy_tree
    from whisper_tpu.models import whisper as JM
    from whisper_tpu.text.tokenizer import (WhisperTokenizer,
                                            build_test_tokenizer_json)

    d = tmp_path_factory.mktemp("cuda_cli")
    build_test_tokenizer_json(str(d / "tokenizer.json"))
    tok = WhisperTokenizer(str(d / "tokenizer.json"))
    cfg = tiny_test_config(n_state=256, n_head=4, n_layer=2,
                           n_vocab=tok.vocab_size, n_audio_ctx=96,
                           n_text_ctx=48)
    params = jax.tree.map(np.asarray,
                          JM.init_params(jax.random.PRNGKey(7), cfg))
    npy_tree.save_whisper(params, cfg, str(d / "dump"))
    rng = np.random.default_rng(3)
    t = np.arange(int(2.3 * 16000)) / 16000.0
    x = (0.3 * np.sin(2 * np.pi * 220.0 * t)
         + 0.1 * rng.standard_normal(t.shape)) * (t % 0.8 < 0.5)
    with wave_mod.open(str(d / "audio.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((x * 20000).astype(np.int16).tobytes())
    return d


def test_cli_transcribes_through_the_kernels(cli_dir, monkeypatch, capsys):
    """The CLI's default dtype on the card is bfloat16, so its default
    invocation runs all three kernels; f32 is refused with a clear
    message instead of failing inside a kernel wrapper."""
    monkeypatch.chdir(cli_dir)
    counters = (KA.attention_bhsd, KB.fused_mlp_block,
                KC.decode_attention_stacked)
    before = [f.launches for f in counters]
    rc = torch_cli.main(["transcribe", "dump", "audio.wav", "en", "out.txt",
                         "--greedy", "--max-depth", "8"])
    out, err = capsys.readouterr()
    assert rc == 0, err
    assert "Transcription finished." in out and os.path.exists("out.txt")
    assert all(f.launches > n for f, n in zip(counters, before))

    rc = torch_cli.main(["transcribe", "dump", "audio.wav", "en", "f32.txt",
                         "--greedy", "--dtype", "float32"])
    assert rc == 1
    assert "bfloat16" in capsys.readouterr().err
    assert not os.path.exists("f32.txt")


def test_cli_beam_search_goes_through_all_five_kernels(cli_dir, monkeypatch,
                                                       capsys):
    """The CLI's default (beam 5) on the card: K1, K2, K3, K3g and K4."""
    monkeypatch.chdir(cli_dir)
    counts = {"K1": lambda: KA.attention_bhsd.launches,
              "K2": lambda: KB.fused_mlp_block.launches,
              "K3": lambda: KC.decode_attention_stacked.launches,
              "K3g": lambda: KC.decode_attention_stacked.group_launches,
              "K4": lambda: KP.permute_lanes_arrays.launches}
    before = {k: f() for k, f in counts.items()}
    rc = torch_cli.main(["transcribe", "dump", "audio.wav", "en", "beam.txt",
                         "--max-depth", "8"])
    out, err = capsys.readouterr()
    assert rc == 0, err
    assert "Transcription finished." in out and os.path.exists("beam.txt")
    grew = {k: f() - before[k] for k, f in counts.items()}
    assert all(n > 0 for n in grew.values()), grew


def test_cli_quantized_caches_go_through_k5_and_k3s(cli_dir, monkeypatch,
                                                   capsys):
    """--kv-quant --self-quant on the card: beam search (the default) runs
    K5 and K3g over the int8 caches, greedy runs K3s and K3."""
    monkeypatch.chdir(cli_dir)
    counts = {"K3": lambda: KC.decode_attention_stacked.launches,
              "K3g": lambda: KC.decode_attention_stacked.group_launches,
              "K3s": lambda: KC.decode_attention_stacked.scaled_launches,
              "K5": lambda: KF.decode_attention_permute_fused.launches}
    for extra, ran in (([], ("K3g", "K5")), (["--greedy"], ("K3", "K3s"))):
        before = {k: f() for k, f in counts.items()}
        rc = torch_cli.main(["transcribe", "dump", "audio.wav", "en", "q.txt",
                             "--kv-quant", "--self-quant", "--max-depth", "8",
                             *extra])
        out, err = capsys.readouterr()
        assert rc == 0, err
        grew = {k: f() - before[k] for k, f in counts.items()}
        assert all(grew[k] > 0 for k in ran), grew


def test_cli_transcribe_many_on_the_card(cli_dir, monkeypatch, capsys):
    """`transcribe-many` on the card (bf16 by default): two files' full
    windows decode as one batch through K1, K2 and K3/K3g; greedy and the
    default beam 5 each write one text per input."""
    monkeypatch.chdir(cli_dir)
    counts = {"K1": lambda: KA.attention_bhsd.launches,
              "K2": lambda: KB.fused_mlp_block.launches,
              "K3": lambda: KC.decode_attention_stacked.launches,
              "K3g": lambda: KC.decode_attention_stacked.group_launches}
    for extra, ran in ((["--greedy"], ("K1", "K2", "K3")),
                       ([], ("K1", "K2", "K3g"))):
        before = {k: f() for k, f in counts.items()}
        rc = torch_cli.main(["transcribe-many", "dump", "en", "many",
                             "audio.wav", "audio.wav", "--batch-size", "4",
                             *extra])
        out, err = capsys.readouterr()
        assert rc == 0, err
        assert "Transcribed 2 files" in out
        assert os.path.exists(os.path.join("many", "audio.txt"))
        grew = {k: f() - before[k] for k, f in counts.items()}
        assert all(grew[k] > 0 for k in ran), grew


def test_cli_timestamps_ladder_and_detect_lang_on_the_card(cli_dir,
                                                          monkeypatch, capsys):
    """`transcribe ... auto out.srt --timestamps --format srt --temperature
    0,0.2` and `detect-lang` on the card (bf16): language detection, the
    timestamped beam search with the ladder, an SRT file."""
    import json

    monkeypatch.chdir(cli_dir)
    before = KA.attention_bhsd.launches
    rc = torch_cli.main(["transcribe", "dump", "audio.wav", "auto", "out.srt",
                         "--timestamps", "--format", "srt", "--temperature",
                         "0,0.2", "--max-depth", "8"])
    out, err = capsys.readouterr()
    assert rc == 0, err
    assert "Detected language:" in out and "Transcription finished." in out
    srt = (cli_dir / "out.srt").read_text()
    assert srt == "" or (srt.startswith("1\n") and " --> " in srt)
    assert KA.attention_bhsd.launches > before
    rc = torch_cli.main(["detect-lang", "dump", "audio.wav", "--top", "3"])
    out, err = capsys.readouterr()
    assert rc == 0, err
    doc = json.loads(out.splitlines()[-1])
    assert len(doc["probs"]) == 3 and doc["language"] in doc["probs"]


@pytest.mark.parametrize("bits", [8, 4])
def test_w8a8_model_runs_k6_and_k7_on_the_card(gen, bits):
    """The encoder over W8A8 weights (int8, or packed int4) on the card:
    4 windows of 48 rows (192 rows: K6) and 24 windows (1152 rows: K7),
    within the plain path's reach: the kernel path's output is finite and
    close to the dequant path's (W8A8 quantizes the activations: ~1e-2
    relative)."""
    import dataclasses

    from whisper_tpu_torch.config import KernelKnobs, tiny_test_config
    from whisper_tpu_torch.ops.kernels import dequant_matmul as KQ
    from whisper_tpu_torch.params import init_params
    from whisper_tpu_torch.quantize import quantize_params

    cfg = tiny_test_config(n_state=256, n_head=4, n_layer=2, n_vocab=128,
                           n_audio_ctx=96, n_text_ctx=48)
    w8a8 = dataclasses.replace(cfg, attention="flash",
                               knobs=KernelKnobs(int8_impl="pallas"))
    params = quantize_params(init_params(cfg, gen, dtype=torch.bfloat16),
                             quantize_encoder=True, bits=bits)
    name = "int4_launches" if bits == 4 else "launches"
    for windows, counter in ((4, KQ.quantized_matmul),
                             (24, KQ.quantized_matmul_big)):
        mel = torch.randn((windows, 80, 96), generator=gen, device="cuda")
        before = getattr(counter, name)
        got = M.encoder_forward(params, mel, w8a8)
        assert getattr(counter, name) == before + 2 * 4  # 4 matmuls a layer
        want = M.encoder_forward(params, mel, dataclasses.replace(
            w8a8, knobs=KernelKnobs()))
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        rel = float((got.float() - want.float()).norm() / want.float().norm())
        assert rel < 5e-2, rel


def test_decode_agreement_on_the_card_equals_the_cpu(gen):
    """`decode_agreement` at a tiny config with int4 weights under
    int8_impl="pallas" (K6 over packed int4 on the card) and int4 cross and
    self caches, f32 on the plain attention path: the same report as the
    same call on the CPU (cuDNN's TF32 convolutions off for the call, so
    the two differ only by f32 summation order). Then the kernel path
    (bf16, attention="flash") runs K3s and K5 over the int4 self cache and
    K6 over the int4 weights, with a finite logit delta."""
    import copy
    import dataclasses
    import math

    from whisper_tpu_torch.config import KernelKnobs, tiny_test_config
    from whisper_tpu_torch.eval import agreement
    from whisper_tpu_torch.ops.kernels import dequant_matmul as KQ
    from whisper_tpu_torch.params import init_params
    from whisper_tpu_torch.quantize import quantize_params

    cfg = dataclasses.replace(  # widths the fused encoder MLP (K2) takes
        tiny_test_config(n_state=256, n_head=4, n_vocab=128, n_audio_ctx=64,
                         n_text_ctx=32),
        knobs=KernelKnobs(int8_impl="pallas"))
    ref = init_params(cfg, gen)
    test = quantize_params(ref, quantize_encoder=True, bits=4)
    kw = dict(eot_id=5, prompt=[1, 2, 3], max_depth=10, n_windows=3,
              beam_size=3, kv_quant_test="int4", self_quant_test="int4")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        before = KQ.quantized_matmul.int4_launches
        got = agreement.decode_agreement(ref, test, cfg, **kw)
        assert KQ.quantized_matmul.int4_launches > before
        want = agreement.decode_agreement(  # ParamTree.to moves in place
            copy.deepcopy(ref).to(device="cpu"),
            copy.deepcopy(test).to(device="cpu"), cfg, **kw)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for strategy in ("greedy", "beam"):
        assert got[strategy] == want[strategy], strategy
    assert abs(got["max_logit_delta_rel"]
               - want["max_logit_delta_rel"]) <= 1e-3

    flash = dataclasses.replace(cfg, attention="flash")
    bf16 = copy.deepcopy(ref).to(dtype=torch.bfloat16)
    counters = {"K3s int4": (KC.decode_attention_stacked,
                             "scaled_int4_launches"),
                "K5 int4": (KF.decode_attention_permute_fused,
                            "int4_launches"),
                "K6 int4": (KQ.quantized_matmul, "int4_launches")}
    before = {k: getattr(*c) for k, c in counters.items()}
    report = agreement.decode_agreement(
        bf16, quantize_params(bf16, quantize_encoder=True, bits=4), flash,
        **kw)
    grew = {k: getattr(*c) - before[k] for k, c in counters.items()}
    assert all(n > 0 for n in grew.values()), grew
    assert math.isfinite(report["max_logit_delta_rel"])


def test_cli_quant_check_and_eval_on_the_card(cli_dir, monkeypatch, capsys):
    """`quant-check --kv int4` on the card (bf16, the kernels: K3s and K5
    over the int8 self cache) prints the report line and exits 0 or 1 by
    the gate; `eval` over a one-item manifest prints its JSON line."""
    import json

    monkeypatch.chdir(cli_dir)
    before = KF.decode_attention_permute_fused.launches
    rc = torch_cli.main(["quant-check", "dump", "--kv", "int4", "--windows",
                         "2", "--max-depth", "6"])
    out, err = capsys.readouterr()
    assert rc in (0, 1), err
    assert ("PASS" if rc == 0 else "FAIL:") in err
    report = json.loads(out.splitlines()[-1])
    assert set(report) == {"greedy", "beam", "max_logit_delta_rel"}
    assert KF.decode_attention_permute_fused.launches > before
    (cli_dir / "m.tsv").write_text("audio.wav\thello world\n")
    rc = torch_cli.main(["eval", "dump", "m.tsv", "en", "--greedy"])
    out, err = capsys.readouterr()
    assert rc == 0, err
    doc = json.loads(out.splitlines()[-1])
    assert doc["utterances"] == 1 and doc["words"] == 2


def _batch_kernel_counts():
    return {"K1": lambda: KA.attention_bhsd.launches,
            "K2": lambda: KB.fused_mlp_block.launches,
            "K3": lambda: KC.decode_attention_stacked.launches,
            "K3g": lambda: KC.decode_attention_stacked.group_launches,
            "K4": lambda: KP.permute_lanes_arrays.launches}


def test_batched_ladder_on_the_card(cli_dir):
    """`BatchTranscriber` on the card (bf16, batches of 4 windows) over two
    short streams: the batched ladder with every window decoded again at
    each temperature (logprob_threshold 0), through `transcribe_many` and
    `transcribe_many_with_timestamps`. The sampling rungs' generators are
    seeded, so a rerun gives the same texts and segments; segment times
    lie in the stream; beam 5 (K3g, K4) and the sampling rungs (K3) run
    after the batched encoder (K1, K2)."""
    from whisper_tpu_torch.io import checkpoint, native
    from whisper_tpu_torch.pipeline.batch import BatchTranscriber
    from whisper_tpu_torch.pipeline.transcribe import DecodeOptions
    from whisper_tpu_torch.text.tokenizer import WhisperTokenizer

    params, cfg = checkpoint.load_params(str(cli_dir / "dump"))
    bt = BatchTranscriber(params, cfg,
                          WhisperTokenizer(str(cli_dir / "tokenizer.json")),
                          batch_size=4, dtype=torch.bfloat16)
    wave, _ = native.load_audio(str(cli_dir / "audio.wav"))
    waves = [wave, np.ascontiguousarray(wave[::-1])]
    opts = DecodeOptions(temperature=(0.0, 0.2, 0.4), logprob_threshold=0.0,
                         no_speech_threshold=0.6, max_depth=8)
    counts = _batch_kernel_counts()
    before = {k: f() for k, f in counts.items()}
    texts = [bt.transcribe_many(waves, options=opts) for _ in range(2)]
    assert texts[0] == texts[1] and len(texts[0]) == 2
    runs = [bt.transcribe_many_with_timestamps(waves, options=opts)
            for _ in range(2)]
    segs = [[[(s.start, s.end, s.text) for s in ss] for _, ss in r]
            for r in runs]
    assert segs[0] == segs[1]
    for (_, ss), w in zip(runs[0], waves):
        assert all(0.0 <= s.start <= s.end <= len(w) / 16000 + 1e-6
                   for s in ss)
    grew = {k: f() - before[k] for k, f in counts.items()}
    assert all(n > 0 for n in grew.values()), grew


def test_transcribe_many_cuts_batches_on_the_card(gen, tmp_path,
                                                 monkeypatch):
    """`transcribe_many` on the card (bf16, batches of 4) over two streams
    of unequal length, a batch crossing from one to the other and the last
    one short: every batch reaches the encoder as a CUDA tensor, and the
    tokens are those of the batches stacked on the host
    (tests/host_stack_batches.py)."""
    from host_stack_batches import host_stack_transcribe_many
    from whisper_tpu_torch.config import tiny_test_config
    from whisper_tpu_torch.params import init_params
    from whisper_tpu_torch.pipeline import transcribe as TT
    from whisper_tpu_torch.pipeline.batch import BatchTranscriber
    from whisper_tpu_torch.text.tokenizer import (WhisperTokenizer,
                                                  build_test_tokenizer_json)

    build_test_tokenizer_json(str(tmp_path / "tokenizer.json"))
    tok = WhisperTokenizer(str(tmp_path / "tokenizer.json"))
    cfg = tiny_test_config(n_state=256, n_head=4, n_layer=2,
                           n_vocab=tok.vocab_size, n_audio_ctx=96,
                           n_text_ctx=48)
    bt = BatchTranscriber(init_params(cfg, gen, dtype=torch.bfloat16), cfg,
                          tok, batch_size=4)
    rng = np.random.default_rng(11)
    t = np.arange(86000) / 16000.0  # 7 full windows and a tail
    speech = (0.3 * np.sin(2 * np.pi * 220.0 * t)
              + 0.1 * rng.standard_normal(t.shape)) * (t % 0.8 < 0.5)
    waves = [speech.astype(np.float32),
             np.ascontiguousarray(speech[:35000][::-1],
                                  dtype=np.float32)]
    opt = TT.DecodeOptions(max_depth=8, chunk_overlap_seconds=0.15)
    seen = []
    real = TT.Transcriber._encode_windows

    def spy(self, w, *a, **k):
        seen.append(w.device.type if isinstance(w, torch.Tensor) else None)
        return real(self, w, *a, **k)

    want = host_stack_transcribe_many(bt, waves, opt)
    monkeypatch.setattr(TT.Transcriber, "_encode_windows", spy)
    got = bt.transcribe_many(waves, options=opt)
    assert got == want and all(tokens for _, tokens in got)
    assert len(seen) == 3 and set(seen) == {"cuda"}


def test_cli_words_on_the_card(cli_dir, monkeypatch, capsys):
    """`transcribe --timestamps --words` on the card (beam 5, bf16): a
    words list on every JSON segment, word times inside the audio and in
    order within a segment, the encoder kernels launched for the decode
    and the alignment passes; `--format vtt --words` writes highlighted
    cues."""
    import json

    monkeypatch.chdir(cli_dir)
    before = KA.attention_bhsd.launches
    rc = torch_cli.main(["transcribe", "dump", "audio.wav", "en",
                         "words.json", "--timestamps", "--words", "--json",
                         "--max-depth", "8"])
    out, err = capsys.readouterr()
    assert rc == 0, err
    doc = json.loads((cli_dir / "words.json").read_text())
    for seg in doc["segments"]:
        starts = [w["start"] for w in seg["words"]]
        assert starts == sorted(starts)
        assert all(0.0 <= w["start"] <= w["end"] <= 2.3 + 1e-3
                   for w in seg["words"])
    assert KA.attention_bhsd.launches > before
    rc = torch_cli.main(["transcribe", "dump", "audio.wav", "en",
                         "words.vtt", "--timestamps", "--words", "--format",
                         "vtt", "--max-depth", "8"])
    assert rc == 0, capsys.readouterr().err
    assert (cli_dir / "words.vtt").read_text().startswith("WEBVTT")


def test_convert_then_transcribe_on_the_card(cli_dir, monkeypatch, capsys):
    """`convert` of the npy dump (on the host), then `transcribe` of the
    converted `.safetensors` + `.cfg` on the card: the dump's text."""
    monkeypatch.chdir(cli_dir)
    assert torch_cli.main(["convert", "dump", "--out", "conv", "--mpk"]) == 0
    out, _ = capsys.readouterr()
    assert out == "Saving model...\nSaving config...\nFinished.\n"
    texts = []
    for model in ("conv", "dump"):
        rc = torch_cli.main(["transcribe", model, "audio.wav", "en",
                             f"{model}.txt", "--greedy", "--max-depth", "8"])
        assert rc == 0, capsys.readouterr().err
        texts.append((cli_dir / f"{model}.txt").read_text())
    assert texts[0] == texts[1]


# The one-block kernel (K3 and K8 over self caches, K3s): every storage x
# query type, with and without row scales (integer caches).
ONE_BLOCK_TYPES = [("bf16", torch.bfloat16, False), ("f32", torch.float32, False),
                   ("int8", torch.bfloat16, False), ("int8", torch.float32, False),
                   ("int4", torch.bfloat16, False), ("int4", torch.float32, False),
                   ("int8", torch.bfloat16, True), ("int8", torch.float32, True),
                   ("int4", torch.bfloat16, True), ("int4", torch.float32, True)]


def _one_block_operands(gen, storage, dtype, scaled, shape, pos):
    """q, k and v caches of `shape` (B, L, C, d) in the storage type, row
    scales with a NaN on each lane's first masked row (layer 2) where
    `scaled`, and pos as an int32 tensor."""
    lim = {"int8": 127, "int4": 7}.get(storage)
    b = shape[0]
    if lim is None:
        dt = torch.float32 if storage == "f32" else torch.bfloat16
        kc = _randn(shape, gen, dtype=dt)
        vc = (_randn(shape, gen, dtype=torch.float32) + 1).to(dt)
        q = _randn((b, shape[3]), gen, 0.125, dtype=dt)
    else:
        kc = torch.randint(-lim, lim + 1, shape, generator=gen, device="cuda",
                           dtype=torch.int8)
        vc = torch.randint(0, lim + 1, shape, generator=gen, device="cuda",
                           dtype=torch.int8)
        q = _randn((b, shape[3]), gen, 0.5 / lim, dtype=dtype)
        if storage == "int4":
            kc, vc = pack_int4(kc), pack_int4(vc)
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    scales = {}
    if scaled:
        ks, vs = (0.01 + 0.04 * torch.rand(shape[:3], generator=gen,
                                           device="cuda") for _ in "kv")
        lanes = torch.arange(b, device="cuda")
        first = (pos_t.long() + 1).clamp(max=shape[2] - 1)
        masked = pos_t.long() + 1 < shape[2]
        ks[lanes[masked], 2, first[masked]] = float("nan")
        vs[lanes[masked], 2, first[masked]] = float("nan")
        scales = dict(k_rowscale=ks, v_rowscale=vs)
    return q, kc, vc, pos_t, scales


@pytest.mark.parametrize("storage,dtype,scaled", ONE_BLOCK_TYPES)
def test_one_block_kernel_at_every_row_count(gen, storage, dtype, scaled):
    """The one-block kernel against its plain version over a 448-row
    batch-major self cache (f32: past the kernel's shared memory, so the
    split kernel's one-block launch): lanes that see 1 (pos 0), 32, 61,
    128 and 448 rows, and one at pos >= c_used (every row read); row scales with a NaN
    on the first masked row stay harmless. Then one int pos for every
    lane, the kernel argument the decoder step passes: 0 (every NaN row
    masked) and 300 (over the scales without their NaNs). One launch a
    call, counted on its counter."""
    q, kc, vc, pos, scales = _one_block_operands(
        gen, storage, dtype, scaled, (6, 3, 448, 256),
        [0, 31, 60, 127, 447, 500])
    counter = ("scaled_int4_launches" if scaled and storage == "int4"
               else "scaled_launches" if scaled else "launches")
    clean = {n: torch.nan_to_num(t, nan=0.02) for n, t in scales.items()}
    for p, sc in ((pos, scales), (0, scales), (300, clean)):
        before = getattr(KC.decode_attention_stacked, counter)
        got = KC.decode_attention_stacked(q, kc, vc, p, 2, 4,
                                          batch_major=True, **sc)
        assert getattr(KC.decode_attention_stacked, counter) == before + 1
        want = KC.decode_attention_stacked_plain(q, kc, vc, p, 2, 4,
                                                 batch_major=True, **sc)
        assert bool(torch.isfinite(got).all())
        _close(got, want, *KC.TOL[dtype])


@pytest.mark.parametrize("storage", ["bf16", "f32", "int8", "int4"])
def test_one_block_route_past_its_rows(gen, storage):
    """A per-lane call at splits = 1 over more rows than the one-block
    kernel holds (a layer-major cache of 1500 rows) takes the split
    kernel's one-block launch: against the plain version at 1, 361, 1000
    and 1500 visible rows, with c_used = 1200, and with an int pos."""
    dtype = torch.float32 if storage == "f32" else torch.bfloat16
    q, kc, vc, pos, _ = _one_block_operands(gen, storage, dtype, False,
                                            (4, 2, 1500, 128),
                                            [0, 360, 999, 1499])
    kc, vc = kc.transpose(0, 1).contiguous(), vc.transpose(0, 1).contiguous()
    for p, cu in ((pos, None), (pos, 1200), (1100, None)):
        got = KC.decode_attention_stacked(q, kc, vc, p, 1, 2, c_used=cu,
                                          splits=1)
        want = KC.decode_attention_stacked_plain(q, kc, vc, p, 1, 2,
                                                 c_used=cu)
        _close(got, want, *KC.TOL[dtype])


def test_one_block_kernel_raises_on_what_it_does_not_take(gen):
    """Row scales (K3s, which only the one-block kernel takes) over more
    rows than it holds, and a negative int pos raise ValueError: nothing
    falls back to the plain version."""
    kc = _randn((2, 1, 16, 128), gen)
    long = torch.zeros((1, 1, 600, 128), dtype=torch.int8, device="cuda")
    rs = torch.ones((1, 1, 600), device="cuda")
    with pytest.raises(ValueError, match="shapes the kernel does not take"):
        KC.decode_attention_stacked(_randn((1, 128), gen), long, long, 3, 0,
                                    2, batch_major=True, k_rowscale=rs,
                                    v_rowscale=rs)
    with pytest.raises(ValueError, match="pos -1"):
        KC.decode_attention_stacked(_randn((2, 128), gen), kc, kc, -1, 0, 2,
                                    batch_major=True)


# The large-M W8A8 route: K6 above 64 rows and K7, (M, K, N) with a ragged
# last row tile (65: one tile; 750: 110 rows of 128; 1025 and 1537: one
# row; 3000: 56 rows).
BIG_SHAPES = [(65, 1280, 1280), (750, 1280, 3840), (750, 5120, 1280),
              (1025, 1280, 1280), (1537, 640, 384), (3000, 1280, 1280)]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,k,n", BIG_SHAPES)
def test_w8a8_big_route_bit_equal_under_every_plan(gen, monkeypatch, m, k, n,
                                                   bits):
    """The prep pass and the wgmma tile kernel, with K6's rounding up to
    1024 rows and K7's above, over normal rows, a zero row and a row of
    exact half steps: bit-equal to the plain version under `plan_big`'s
    tile and both widths the kernel takes (`plan_big` patched), with a
    bf16 and an f32 output."""
    from whisper_tpu_torch.ops.kernels import dequant_matmul as KQ

    x, wq, scale = _w8a8_operands(gen, m, k, n, torch.bfloat16, bits)
    fn = KQ.quantized_matmul if m <= 1024 else KQ.quantized_matmul_big
    plain = KQ.quantized_matmul_plain if m <= 1024 else \
        KQ.quantized_matmul_big_plain
    want = plain(x, wq, scale)
    assert want.abs().amax() > 0
    plan_big = KQ.plan_big
    for tile in (None, 256, 128):
        if tile and n % tile:
            continue
        monkeypatch.setattr(KQ, "plan_big",
                            lambda m, n: tile or plan_big(m, n))
        got = fn(x, wq, scale)
        torch.cuda.synchronize()
        assert torch.equal(got, want), tile
    monkeypatch.setattr(KQ, "plan_big", plan_big)
    f32 = fn(x, wq, scale, out_dtype=torch.float32)
    assert torch.equal(f32, plain(x, wq, scale, out_dtype=torch.float32))


def test_w8a8_big_route_raises_on_tiles_it_does_not_take(gen, monkeypatch):
    """A tile width that does not divide N, or that the kernel has no
    instance for (`plan_big` patched to give it), raises ValueError:
    nothing falls back."""
    from whisper_tpu_torch.ops.kernels import dequant_matmul as KQ

    x, wq, scale = _w8a8_operands(gen, 200, 128, 384, torch.bfloat16)
    monkeypatch.setattr(KQ, "plan_big", lambda m, n: 256)
    with pytest.raises(ValueError, match="shapes the kernel does not take"):
        KQ.quantized_matmul(x, wq, scale)
    monkeypatch.setattr(KQ, "plan_big", lambda m, n: 64)
    with pytest.raises(ValueError, match="shapes the kernel does not take"):
        KQ.quantized_matmul_big(x, wq, scale)


def test_tiny_draft_runs_the_kernels_at_d384(gen, tmp_path):
    """`Transcriber(draft=...)` with tiny's widths (d 384, 6 heads of 64,
    4 decoder layers) for both models, random bf16 weights: the greedy
    window decodes speculatively, K1, K2 and K3 launch at d 384, and the
    text equals the draftless greedy's."""
    from whisper_tpu_torch.config import preset
    from whisper_tpu_torch.decode import speculative as S
    from whisper_tpu_torch.params import init_params
    from whisper_tpu_torch.pipeline.transcribe import (DecodeOptions,
                                                       Transcriber)
    from whisper_tpu_torch.text.tokenizer import (
        WhisperTokenizer, build_full_scale_tokenizer_json)

    cfg = preset("tiny")
    build_full_scale_tokenizer_json(str(tmp_path / "tok.json"))
    tok = WhisperTokenizer(str(tmp_path / "tok.json"))
    params = init_params(cfg, gen, dtype=torch.bfloat16)
    draft = init_params(cfg, torch.Generator(device="cuda").manual_seed(1),
                        dtype=torch.bfloat16)
    t = np.arange(5 * 16000) / 16000.0
    wave = (0.3 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32)
    opt = DecodeOptions(strategy="greedy", max_depth=40)
    plain = Transcriber(params, cfg, tok).transcribe(wave, 16000, opt)
    spec = Transcriber(params, cfg, tok, draft=(draft, cfg), draft_k=4)
    names = ((KA.attention_bhsd, "launches"), (KB.fused_mlp_block, "launches"),
             (KC.decode_attention_stacked, "launches"))
    before = [getattr(f, a) for f, a in names]
    S.speculative_greedy_decode.iterations = 0
    got = spec.transcribe(wave, 16000, opt)
    launched = [getattr(f, a) - b for (f, a), b in zip(names, before)]
    assert S.speculative_greedy_decode.iterations > 0
    assert all(n > 0 for n in launched), launched
    assert got == plain


def _kernel_entry_points(gen):
    """name -> (call, the floating input to mark as requiring grad,
    (wrapper, counter)): one valid call of every kernel entry point."""
    from whisper_tpu_torch.ops.kernels import dequant_matmul as KQ

    q, k, v = (_randn((2, 64, 128), gen) for _ in "qkv")
    hq, hk, hv = (_randn((2, 64, 2, 64), gen).transpose(1, 2) for _ in "qkv")
    mlp = (_randn((64, 256), gen), _randn((256,), gen, 0.1) + 1,
           _randn((256,), gen, 0.1), _randn((256, 1024), gen, 0.06),
           _randn((1024,), gen, 0.05), _randn((1024, 256), gen, 0.03),
           _randn((256,), gen, 0.05))
    dq = _randn((3, 128), gen, 0.125)
    kc, vc = (_randn((3, 4, 50, 128), gen) for _ in "kv")
    pos = torch.tensor([0, 17, 39], dtype=torch.int32, device="cuda")
    arrays = [_randn((6, 2, 64, 128), gen) for _ in range(2)]
    out = [torch.empty_like(a) for a in arrays]
    parents = torch.tensor([1, 1, 0, 5, 2, 2], dtype=torch.int32,
                           device="cuda")
    b, d = 10, 256
    ints = [torch.randint(-127, 128, (b, 2, 64, d), generator=gen,
                          device="cuda", dtype=torch.int8) for _ in "kv"]
    scales = [0.01 + 0.04 * torch.rand((b, 2, 64), generator=gen,
                                       device="cuda") for _ in "kv"]
    new = [torch.randint(-127, 128, (b, d), generator=gen, device="cuda",
                         dtype=torch.int8) for _ in "kv"]
    new_s = [0.01 + 0.04 * torch.rand(b, generator=gen, device="cuda")
             for _ in "kv"]
    fq = _randn((b, d), gen)
    lanes = torch.arange(b, device="cuda")
    x6, w6, s6 = _w8a8_operands(gen, 5, 256, 384, torch.bfloat16)
    x7, w7, s7 = _w8a8_operands(gen, 10, 256, 384, torch.bfloat16)
    return {
        "K1 attention_bhsd": (lambda: KA.attention_bhsd(q, k, v, 2), q,
                              (KA.attention_bhsd, "launches")),
        "K9 flash_attention": (lambda: KA.flash_attention(hq, hk, hv), hq,
                               (KA.flash_attention, "launches")),
        "K2 fused_mlp_block": (lambda: KB.fused_mlp_block(*mlp), mlp[3],
                               (KB.fused_mlp_block, "launches")),
        "K3 decode_attention_stacked": (
            lambda: KC.decode_attention_stacked(dq, kc, vc, pos, 2, 2,
                                                batch_major=True),
            kc, (KC.decode_attention_stacked, "launches")),
        "K8 decode_attention": (
            lambda: KC.decode_attention(dq, kc[:, 2], vc[:, 2], pos, 2), dq,
            (KC.decode_attention, "flat_launches")),
        "K4 permute_lanes_arrays": (
            lambda: KP.permute_lanes_arrays(arrays, parents, out),
            arrays[0], (KP.permute_lanes_arrays, "launches")),
        "K5 decode_attention_permute_fused": (
            lambda: KF.decode_attention_permute_fused(
                fq, *ints, *scales, *new, *new_s, lanes, 37, 1, 4, 5),
            fq, (KF.decode_attention_permute_fused, "launches")),
        "K6 quantized_matmul": (lambda: KQ.quantized_matmul(x6, w6, s6), x6,
                                (KQ.quantized_matmul, "launches")),
        "K7 quantized_matmul_big": (
            lambda: KQ.quantized_matmul_big(x7, w7, s7), s7,
            (KQ.quantized_matmul_big, "launches")),
    }


KERNEL_ENTRY_POINTS = ["K1 attention_bhsd", "K9 flash_attention",
                       "K2 fused_mlp_block", "K3 decode_attention_stacked",
                       "K8 decode_attention", "K4 permute_lanes_arrays",
                       "K5 decode_attention_permute_fused",
                       "K6 quantized_matmul", "K7 quantized_matmul_big"]


@pytest.mark.parametrize("name", KERNEL_ENTRY_POINTS)
def test_kernels_refuse_a_gradient_and_launch_without_one(gen, name):
    """On a CUDA input that requires grad, under grad mode, every kernel
    entry point raises RuntimeError and launches nothing (no plain
    version in its place); under no_grad the same call launches once."""
    call, marked, (fn, counter) = _kernel_entry_points(gen)[name]
    marked.requires_grad_(True)
    before = getattr(fn, counter)
    with pytest.raises(RuntimeError, match="no backward"):
        call()
    assert getattr(fn, counter) == before
    with torch.no_grad():
        call()
    torch.cuda.synchronize()
    assert getattr(fn, counter) == before + 1


def test_train_step_on_the_card_equals_the_cpu(gen, monkeypatch):
    """One `make_train_step` (remat, learning rate above 0 from the first
    step) at a tiny f32 config on the card and on the CPU from the same
    weights and batch: loss, grad_norm and every leaf within 1e-4
    relative (full f32: TF32 off for matmuls and convolutions)."""
    from whisper_tpu_torch.config import tiny_test_config
    from whisper_tpu_torch.params import init_params, trainable
    from whisper_tpu_torch.training import train as TT

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = tiny_test_config(n_state=64, n_head=2, n_layer=2, n_vocab=300,
                           n_audio_ctx=64, n_text_ctx=32)
    start = init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = TT.Batch(
        torch.from_numpy(rng.standard_normal((2, 80, 64)).astype(np.float32)),
        torch.from_numpy(rng.integers(0, 300, (2, 32)).astype(np.int32)),
        torch.from_numpy((rng.random((2, 32)) < 0.6).astype(np.float32)))
    opt = TT.make_optimizer(learning_rate=1e-3, warmup_steps=0,
                            total_steps=10)
    step = TT.make_train_step(cfg, opt, remat=True)
    results = {}
    for device in ("cpu", "cuda"):
        state, metrics = step(TT.init_train_state(
            trainable(start, device=device), opt), batch)
        results[device] = (metrics, dict(state.params.named_parameters()))
    (mc, pc), (mg, pg) = results["cpu"], results["cuda"]
    for key in ("loss", "grad_norm", "accuracy", "tokens"):
        np.testing.assert_allclose(float(mg[key]), float(mc[key]),
                                   rtol=1e-4, err_msg=key)
    # the key bias (qkv_b[:, 1], cross_kv_b[:, 0]) has a zero gradient up
    # to rounding noise, which AdamW scales to updates of up to the
    # learning rate that depend on the noise: bounded apart
    k_bias = {"encoder.blocks.qkv_b": 1, "decoder.blocks.qkv_b": 1,
              "decoder.blocks.cross_kv_b": 0}
    for name, p in pc.items():
        got, want = pg[name].detach().cpu(), p.detach()
        if name in k_bias:
            col = k_bias[name]
            assert float((got[:, col] - want[:, col]).abs().max()) <= 1e-3
            keep = [i for i in range(want.shape[1]) if i != col]
            got, want = got[:, keep], want[:, keep]
        rel = float((got - want).norm() / want.norm())
        assert rel <= 1e-4, (name, rel)


def test_tp_ranks_on_one_card_match_the_meshless_kernel_path(gen, tmp_path):
    """Two SPMD ranks (gloo) on cuda:0 at a tiny config (d 384, 6 heads:
    3 heads and 192 channels a rank) through the kernels: a window's
    encoder output and the first S=1 step's logits within 5e-2 relative L2
    of the meshless kernel path on the same bf16 weights (chip_smoke's
    PATH_RTOL), K1 and K3 launched on every rank, K2 never (it has no tp
    decomposition)."""
    import torch_parallel_rank as rank_side
    from whisper_tpu_torch.ops.audio import max_waveform_samples
    from whisper_tpu_torch.parallel import launch
    from whisper_tpu_torch.pipeline.transcribe import DecodeOptions
    from whisper_tpu_torch.text.tokenizer import build_test_tokenizer_json

    tok = str(tmp_path / "tokenizer.json")
    build_test_tokenizer_json(tok)
    rng = np.random.default_rng(0)
    n = max_waveform_samples(1490)
    wave = (0.1 * rng.standard_normal(2 * n)).astype(np.float32)
    case = dict(dims=dict(n_state=384, n_head=6, n_layer=2, n_vocab=366,
                          n_audio_ctx=1500, n_text_ctx=448),
                seed=0, tok=tok, tp=2, window=wave[:n], wave=wave,
                opts=dict(strategy="greedy", max_depth=20))
    outs = launch.spawn(rank_side.run_cuda_case, 2, (case,),
                        init_method=launch.file_init_method(str(tmp_path)),
                        backend="gloo", timeout_s=300.0)
    tr = rank_side.cuda_transcriber(case)
    enc, logits = rank_side.first_step(tr, case["window"],
                                       DecodeOptions(**case["opts"]))
    for out in outs:
        assert out["device"].startswith("cuda")
        for got, want in ((out["enc"], enc), (out["logits"], logits)):
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= 5e-2, rel
        k1, k2, k3 = out["launches"]
        assert k1 > 0 and k3 > 0 and k2 == 0, out["launches"]
    assert outs[0]["tokens"] == outs[1]["tokens"]


@pytest.mark.parametrize("v", [51866, 51865])
@pytest.mark.parametrize("b", [1, 5, 128])
def test_tied_head_is_one_bf16_gemm_with_f32_logits(gen, b, v):
    """The tied head on bf16 operands on the card (turbo's and large-v2's
    vocabularies, d 1280, N(0, 1) values): f32 logits within 1e-3 of the
    f32 product, the same argmax on every row whose two best logits lie
    more than 1e-3 apart, and no f32 copy of the embedding (the call's
    peak rises by less than its V x d x 4 bytes)."""
    d = 1280
    x, emb = _randn((b, 1, d), gen), _randn((v, d), gen)
    dec = {"tok_emb": emb}
    want = torch.matmul(x.float(), emb.float().t())
    M._logits(x, dec)  # cuBLAS's handle and workspace, outside the peak
    torch.cuda.synchronize()
    before = M._logits.tensor_core_calls, M._logits.f32_calls
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = M._logits(x, dec)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < v * d * 4
    assert (M._logits.tensor_core_calls, M._logits.f32_calls) == (
        before[0] + 1, before[1])
    assert got.dtype == torch.float32 and got.shape == (b, 1, v)
    assert float((got - want).abs().max()) <= 1e-3
    top = want[:, 0].topk(2, dim=-1).values
    clear = (top[:, 0] - top[:, 1]) > 1e-3
    assert torch.equal(got[:, 0].argmax(-1)[clear],
                       want[:, 0].argmax(-1)[clear])


# (rows, in width, out shape) at large-v3-turbo's widths: the encoder's
# QKV, out-projection and `init_cache`'s cross K/V over two windows of 750
# positions, then the B = 128 step's QKV, attention out / cross q / cross
# out, MLP1 and MLP2, then the same at B = 1 (a tail's step, where PyTorch
# copies the bias and runs a beta = 1 GEMM in place of cuBLASLt's epilogue)
EPILOGUE_SHAPES = [(1500, 1280, (3, 1280)), (1500, 1280, (1280,)),
                   (1500, 1280, (2, 1280)), (128, 1280, (3, 1280)),
                   (128, 1280, (1280,)), (128, 1280, (5120,)),
                   (128, 5120, (1280,)), (1, 1280, (3, 1280)),
                   (1, 1280, (1280,)), (1, 1280, (5120,)),
                   (1, 5120, (1280,))]


@pytest.mark.parametrize("m,k,out_shape", EPILOGUE_SHAPES)
def test_projection_bias_goes_into_the_gemm_epilogue(gen, m, k, out_shape):
    """A bf16 projection on the card (`_linear`, or `_qkv_proj` /
    `_kv_proj` for a (3, d) / (2, d) out shape) adds its bias to the f32
    sums and rounds once: within one bf16 ulp (atol 0, rtol 2^-8) of the
    f32 product plus the bias, rounded to bf16 (the two may differ only
    in the order of the f32 sums), counted by
    `_linear.epilogue_bias_calls` alone."""
    x = _randn((m, 1, k), gen)
    w = _randn((k, *out_shape), gen, k ** -0.5)
    b = _randn(out_shape, gen)
    proj = {(3, 1280): M._qkv_proj, (2, 1280): M._kv_proj}.get(out_shape,
                                                                 M._linear)
    before = M._linear.epilogue_bias_calls, M._linear.bias_add_calls
    got = proj(x, w, b)
    after = M._linear.epilogue_bias_calls, M._linear.bias_add_calls
    got = torch.stack(got, dim=-2) if isinstance(got, tuple) else got
    want = (torch.mm(x.reshape(m, k), w.reshape(k, -1),
                     out_dtype=torch.float32) + b.reshape(-1).float())
    want = want.bfloat16().reshape(m, 1, *out_shape)
    assert after == (before[0] + 1, before[1])
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    _close(got, want, atol=0, rtol=2 ** -8)


def _bias_params(cfg, gen):
    """Random bf16 weights on the card with N(0, 0.1) biases and layer
    norm shifts (`init_params` makes them zero, which no rounding of the
    bias would show)."""
    from whisper_tpu_torch.params import init_params

    params = init_params(cfg, gen, dtype=torch.bfloat16)
    for name, t in params.named_buffers():
        if name.endswith("_b"):
            t.copy_(_randn(t.shape, gen, 0.1))
    return params


@pytest.mark.parametrize("b", [128, 1])
def test_step_graph_replays_the_eager_step_with_the_epilogue_bias(gen, b):
    """A B = 128 or B = 1 S = 1 step (tiny's widths through the kernels, a
    tensor pos as the greedy step graphs take it) captured as a CUDA graph
    with the biases in the GEMMs' epilogues: the replay's logits and self
    cache equal the eager step's bit for bit, the capture counts six
    epilogue projections a layer and no separate add, the replay none."""
    from whisper_tpu_torch.config import preset

    cfg = dataclasses.replace(preset("tiny"), attention="flash")
    params = _bias_params(cfg, gen)
    vocab = cfg.text_decoder_config.n_vocab
    enc = _randn((b, 750, cfg.n_state), gen)
    cache = M.init_cache(params, enc, cfg, cache_len=64)
    tokens = torch.randint(0, vocab, (b, 1), generator=gen, device="cuda")
    pos = torch.full((b,), 5, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        eager = M.DecoderCache(*(t.clone() for t in cache))
        want, _ = M.decoder_step(params, tokens, pos, eager, cfg)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # the warm-up a capture needs
            M.decoder_step(params, tokens, pos, cache, cfg)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = M._linear.epilogue_bias_calls, M._linear.bias_add_calls
        with torch.cuda.graph(graph):
            got, _ = M.decoder_step(params, tokens, pos, cache, cfg)
        captured = M._linear.epilogue_bias_calls, M._linear.bias_add_calls
        graph.replay()
        torch.cuda.synchronize()
    n_layer = cfg.text_decoder_config.n_text_layer
    assert captured == (before[0] + 6 * n_layer, before[1])
    assert (M._linear.epilogue_bias_calls,
            M._linear.bias_add_calls) == captured
    assert torch.equal(got, want)
    assert torch.equal(cache.self_k, eager.self_k)
    assert torch.equal(cache.self_v, eager.self_v)


# encoder_forward on the card (bf16, the kernels, the biases in the
# GEMMs' epilogues) against the same weights in f32 on the CPU: relative
# L2 over the output. bf16 keeps 8 significant bits (a rounding's
# relative error up to 2^-9, ~1.1e-3 rms); tiny's 4 layers round ~10
# times each, ~1e-2 as a random walk, and 2e-2 leaves twice that. On an
# H100 (torch 2.11, cuBLAS 12.8) the epilogue read 0.005231 and the
# separate add 0.005246: rounding once lands 0.3% closer
ENC_CARD_RTOL = 2e-2


def test_encoder_with_epilogue_bias_against_f32_on_the_cpu(gen,
                                                           monkeypatch):
    """`encoder_forward` at B = 2 (tiny's widths: d 384, 6 heads, 4
    layers, 750 positions a window; N(0, 0.1) biases) on the card within
    ENC_CARD_RTOL of the f32 forward on the CPU; two epilogue projections
    a layer (QKV and the attention out; the MLP is K2). The fused route
    rounds once where the separate add rounds twice: it lands no farther
    from f32 than the separate add (`_epilogue_bias` forced false), within
    2% of its error, and both errors are printed."""
    from whisper_tpu_torch.config import preset

    cfg = dataclasses.replace(preset("tiny"), attention="flash")
    params = _bias_params(cfg, gen)
    mel = torch.randn((2, 80, 1500), generator=gen, device="cuda")
    ref = copy.deepcopy(params).to(device="cpu", dtype=torch.float32)
    with torch.no_grad():
        want = M.encoder_forward(ref, mel.cpu(), dataclasses.replace(
            cfg, attention="xla"))
        before = M._linear.epilogue_bias_calls, M._linear.bias_add_calls
        fused = M.encoder_forward(params, mel, cfg).float().cpu()
        after = M._linear.epilogue_bias_calls, M._linear.bias_add_calls
        monkeypatch.setattr(M, "_epilogue_bias", lambda x, w, b: False)
        added = M.encoder_forward(params, mel, cfg).float().cpu()
    n_layer = cfg.audio_encoder_config.n_audio_layer
    assert after == (before[0] + 2 * n_layer, before[1])

    def rel(got):
        return float((got - want).norm() / want.norm())

    print(f"encoder vs f32: epilogue {rel(fused):.6f}, separate add "
          f"{rel(added):.6f}")
    assert rel(fused) <= ENC_CARD_RTOL
    assert rel(fused) <= 1.02 * rel(added)


def test_profiler_records_cuda_events_after_the_cli_tests(gen):
    """In this process, after the CLI tests above, the process's first
    profiling sessions: two that run one PyTorch op, then two that run one
    K4 launch (a kernel of the port, launched through ctypes). The launch
    tests count in a process of their own (`_in_own_process`) because a
    session here once recorded no CUDA events; this prints the CUDA events
    each session records, and holds that a session after the first
    records the PyTorch op."""
    from torch.profiler import ProfilerActivity, profile

    x = _randn((1024,), gen)
    arrays = [_randn((2, 1, 32, 128), gen)]
    out = [torch.empty_like(arrays[0])]
    parents = torch.tensor([1, 0], dtype=torch.int32, device="cuda")
    work = {"op": lambda: (x * 2).sum(),
            "K4": lambda: KP.permute_lanes_arrays(arrays, parents, out)}
    work["K4"]()  # builds the kernels, outside any session

    def cuda_events(name):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            work[name]()
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)

    counts = [(name, cuda_events(name)) for name in ("op", "op", "K4", "K4")]
    print("profiler CUDA events by session:", counts)
    assert counts[1][1] > 0, counts


if __name__ == "__main__":  # `_in_own_process`'s child: one check
    import sys

    globals()[sys.argv[1]](torch.Generator(device="cuda").manual_seed(0))
