"""The plain PyTorch versions of the port's kernels (K1 flash attention, K2
fused MLP, K3/K3g decode attention, K4 lane permute) vs the JAX Pallas
kernels they replace, run as tests/test_pallas.py runs them on the CPU
(interpret=True), plus the CPU dispatch, the launch counters and the build
helper.

Tolerances: f32 inputs agree to summation order (ATOL_F32 = 2e-5; the
fused MLP also carries the Pallas A&S erf polynomial, abs err <= 1.5e-7).
bf16 inputs round at the same points in both, but a different f32
summation order can move a bf16 intermediate or output by one rounding
step (2^-8 relative), so BF16 = (atol 2e-2, rtol 1e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.ops.pallas.decode_attention import (
    decode_attention_stacked as j_decode)
from whisper_tpu.ops.pallas.encoder_block import fused_mlp_block as j_mlp
from whisper_tpu.ops.pallas.flash_attention import attention_bhsd as j_flash
from whisper_tpu.ops.pallas.permute import permute_lanes_arrays as j_permute
from whisper_tpu_torch.ops.kernels import _build
from whisper_tpu_torch.ops.kernels import decode_attention as KC
from whisper_tpu_torch.ops.kernels import encoder_block as KB
from whisper_tpu_torch.ops.kernels import flash_attention as KA
from whisper_tpu_torch.ops.kernels import permute as KP

ATOL_F32 = 2e-5
BF16 = dict(atol=2e-2, rtol=1e-2)


def _np(t):
    return t.float().numpy()


def _both(arr, dtype):
    """The same numpy values as a JAX array and a torch tensor of dtype."""
    jd = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    return jnp.asarray(arr, jd), torch.from_numpy(arr).to(dtype)


def _check(got, want, dtype):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(got), want, atol=ATOL_F32, rtol=0)
    else:
        np.testing.assert_allclose(_np(got), want, **BF16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,causal", [(24, 24, False), (24, 24, True),
                                          (5, 37, False)])
def test_flash_attention_plain_matches_pallas(dtype, sq, sk, causal):
    rng = np.random.default_rng(sq + sk)
    b, d, heads = 2, 128, 2  # head dim 64, as every Whisper size
    q, k, v = (rng.standard_normal((b, n, d)).astype(np.float32)
               for n in (sq, sk, sk))
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    want = j_flash(jq, jk, jv, n_head=heads, causal=causal, interpret=True)
    got = KA.attention_bhsd(tq, tk, tv, heads, causal=causal)
    assert got.dtype == dtype and got.shape == (b, sq, d)
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mlp_plain_matches_pallas(dtype):
    rng = np.random.default_rng(1)
    m, d, h = 40, 128, 512
    arrs = [
        rng.standard_normal((m, d)),
        1 + 0.1 * rng.standard_normal(d), 0.1 * rng.standard_normal(d),
        0.05 * rng.standard_normal((d, h)), 0.05 * rng.standard_normal(h),
        0.05 * rng.standard_normal((h, d)), 0.05 * rng.standard_normal(d),
    ]
    pairs = [_both(a.astype(np.float32), dtype) for a in arrs]
    want = j_mlp(*(p[0] for p in pairs), interpret=True)
    got = KB.fused_mlp_block(*(p[1] for p in pairs))
    assert got.dtype == dtype and got.shape == (m, d)
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch_major", [True, False])
@pytest.mark.parametrize("c_used", [None, 32])
def test_decode_attention_plain_matches_pallas(dtype, batch_major, c_used):
    rng = np.random.default_rng(2)
    b, n_layer, c, d, heads, layer = 4, 3, 64, 128, 2, 1
    shape = (b, n_layer, c, d) if batch_major else (n_layer, b, c, d)
    kc, vc = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    q = (rng.standard_normal((b, d)) * 0.125).astype(np.float32)
    hi = (c_used or c) - 1
    pos = np.array([0, 7, hi // 2, hi], np.int32)  # mixed visibility
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, kc, vc))
    want = j_decode(jq, jk, jv, jnp.asarray(pos), jnp.int32(layer), heads,
                    interpret=True, batch_major=batch_major, c_used=c_used)
    got = KC.decode_attention_stacked(tq, tk, tv, torch.from_numpy(pos),
                                      layer, heads, batch_major=batch_major,
                                      c_used=c_used)
    assert got.dtype == dtype and got.shape == (b, d)
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch_major", [True, False])
@pytest.mark.parametrize("rep", [2, 5])
def test_decode_attention_group_plain_matches_pallas(dtype, batch_major, rep):
    """K3g: kv row j serves q rows [j*rep, (j+1)*rep). Every lane of a
    window sees the same rows (the grouped TPU kernel reads one pos per
    window); the windows' pos differ."""
    rng = np.random.default_rng(rep)
    bk, n_layer, c, d, heads, layer = 3, 2, 40, 128, 2, 1
    shape = (bk, n_layer, c, d) if batch_major else (n_layer, bk, c, d)
    kc = rng.standard_normal(shape).astype(np.float32)
    vc = (1 + rng.standard_normal(shape)).astype(np.float32)
    q = (rng.standard_normal((bk * rep, d)) * 0.125).astype(np.float32)
    pos = np.repeat(np.array([c - 1, 4, 21], np.int32), rep)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, kc, vc))
    want = j_decode(jq, jk, jv, jnp.asarray(pos), jnp.int32(layer), heads,
                    interpret=True, batch_major=batch_major, kv_rep=rep)
    got = KC.decode_attention_stacked(tq, tk, tv, torch.from_numpy(pos),
                                      layer, heads, batch_major=batch_major,
                                      kv_rep=rep)
    assert got.dtype == dtype and got.shape == (bk * rep, d)
    _check(got, want, dtype)


def test_decode_attention_scalar_pos_and_unported_variants():
    rng = np.random.default_rng(3)
    kc = torch.from_numpy(rng.standard_normal((2, 2, 16, 128)).astype(
        np.float32))
    q = torch.from_numpy(rng.standard_normal((2, 128)).astype(np.float32))
    a = KC.decode_attention_stacked(q, kc, kc, 9, 0, 2, batch_major=True)
    b = KC.decode_attention_stacked(q, kc, kc, torch.tensor([9, 9]), 0, 2,
                                    batch_major=True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="kv_rep"):  # 2 q rows, 2 kv rows
        KC.decode_attention_stacked(q, kc, kc, 9, 0, 2, kv_rep=2)
    scales = torch.ones(2, 2, 16)  # K3s takes row scales batch-major only
    with pytest.raises(ValueError, match="batch_major"):
        KC.decode_attention_stacked(q, kc, kc, 9, 0, 2, k_rowscale=scales,
                                    v_rowscale=scales)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_permute_plain_matches_pallas_whole_slabs(dtype):
    rng = np.random.default_rng(4)
    arrs = [rng.standard_normal((5, 2, 32, 128)).astype(np.float32)
            for _ in range(2)]
    parents = np.array([2, 2, 0, 4, 1], np.int32)
    pairs = [_both(a, dtype) for a in arrs]
    want = j_permute([p[0] for p in pairs], jnp.asarray(parents),
                     interpret=True)
    out = [torch.zeros_like(p[1]) for p in pairs]
    got = KP.permute_lanes_arrays([p[1] for p in pairs],
                                  torch.from_numpy(parents), out)
    assert all(g is o for g, o in zip(got, out))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w, np.float32))


@pytest.mark.parametrize("valid_len", [5, 37, 64])
def test_permute_plain_matches_pallas_prefix(valid_len):
    """Prefix mode with mixed ranks: two (B, L, C, d) caches copy rows
    [0, ceil(valid/32)*32), two (B, L, C) arrays copy whole; compared on
    the rows the kernels copy (the TPU kernel leaves the rest
    uninitialised)."""
    rng = np.random.default_rng(valid_len)
    b, n_layer, c = 4, 2, 64
    arrs = [rng.standard_normal((b, n_layer, c, 128)).astype(np.float32)
            for _ in range(2)]
    arrs += [rng.standard_normal((b, n_layer, c)).astype(np.float32)
             for _ in range(2)]
    parents = np.array([3, 0, 0, 1], np.int32)
    want = j_permute([jnp.asarray(a) for a in arrs], jnp.asarray(parents),
                     interpret=True, valid_len=jnp.int32(valid_len))
    out = [torch.zeros(a.shape) for a in arrs]
    KP.permute_lanes_arrays([torch.from_numpy(a) for a in arrs],
                            torch.from_numpy(parents), out,
                            valid_len=valid_len)
    rows = -(-valid_len // 32) * 32
    for g, w, a in zip(out, want, arrs):
        g, w = g.numpy(), np.asarray(w)
        if a.ndim == 4:
            np.testing.assert_array_equal(g[:, :, :rows], w[:, :, :rows])
            assert not g[:, :, rows:].any()  # left as the buffer was
        else:
            np.testing.assert_array_equal(g, w)


def test_permute_plain_raises_on_aliased_out():
    x, y = torch.randn(3, 2, 8, 16), torch.randn(3, 2, 8, 16)
    par = torch.tensor([1, 0, 2])
    for out in ((x, torch.empty_like(y)), (torch.empty_like(x), x),
                (torch.empty_like(x), y.view(3, 2, 8, 16))):
        with pytest.raises(ValueError, match="overlaps"):
            KP.permute_lanes_arrays((x, y), par, out)
    with pytest.raises(ValueError, match="multiple of chunk"):
        KP.permute_lanes_arrays((x,), par, (torch.empty_like(x),),
                                valid_len=3, chunk=5)


def test_cpu_tensors_never_launch_a_kernel():
    counters = (KA.attention_bhsd, KB.fused_mlp_block,
                KC.decode_attention_stacked, KP.permute_lanes_arrays)
    before = [f.launches for f in counters]
    before_group = KC.decode_attention_stacked.group_launches
    x = torch.randn(1, 8, 128)
    KA.attention_bhsd(x, x, x, 2)
    KB.fused_mlp_block(x, torch.ones(128), torch.zeros(128),
                       torch.randn(128, 512), torch.zeros(512),
                       torch.randn(512, 128), torch.zeros(128))
    KC.decode_attention_stacked(x[:, 0], x[None], x[None], 3, 0, 2)
    KC.decode_attention_stacked(x[0, :4], x[None], x[None], 3, 0, 2,
                                kv_rep=4)
    KP.permute_lanes_arrays((x,), torch.tensor([0]), (torch.empty_like(x),))
    assert [f.launches for f in counters] == before == [0, 0, 0, 0]
    assert KC.decode_attention_stacked.group_launches == before_group == 0
    assert _build._lib is None  # nothing was built or loaded


def test_build_keys_library_by_source_hash(tmp_path, monkeypatch):
    for p in _build.CSRC.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path()
    assert first.parent == _build.BUILD_DIR
    cu = next(tmp_path.glob("*.cu"))
    cu.write_text(cu.read_text() + "\n// edit\n")
    assert _build.library_path() != first


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_entry_signatures_match_the_sources(name):
    """Each C entry's ctypes argtypes are its declaration in csrc/, one
    parameter at a time: a pointer is c_void_p, int c_int, long long
    c_longlong, float c_float (a stale list passes a shifted argument list
    or fails only on the card)."""
    import re

    text = "\n".join(p.read_text() for p in _build.CSRC.glob("*.cu"))
    decl = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
    assert decl, name
    kinds = {"int": _build._I, "long long": _build._LL,
             "float": _build._F}
    want = []
    for param in decl.group(1).split(","):
        words = param.replace("const ", "").split()
        want.append(_build._P if "*" in param
                    else kinds[" ".join(words[:-1])])
    assert _build.SIGNATURES[name] == want


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(_build.Path, "exists", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


@pytest.mark.parametrize("n_head,n_kv,rep,c_used,splits", [
    (20, 1, 5, 750, 4),    # large-v2 beam 5, one window: 80 blocks
    (20, 6, 5, 750, 4),    # six windows: 480 blocks
    (20, 7, 5, 750, 2),    # seven: 280 blocks
    (20, 14, 5, 750, 1),   # fourteen already put 280 blocks in flight
    (20, 1, 16, 750, 4),   # two groups of 8 lanes: 160 blocks
    (20, 1, 5, 300, 2),    # at least 96 rows a block
    (20, 1, 5, 191, 1),    # too few rows to split
    (20, 1, 5, 1, 1),
    (4, 33, 5, 1500, 2),   # 132 blocks, doubled
])
def test_k3g_split_plan(n_head, n_kv, rep, c_used, splits):
    """K3g's cluster size: the least power of two that puts 264 blocks in
    flight, capped at 4 and at 96 rows a block."""
    assert KC.plan_splits(n_head, n_kv, rep, c_used) == splits


@pytest.mark.parametrize("n_head,n_lane,c_used,splits", [
    (20, 1, 750, 8),     # large-v2 greedy, cross: 160 blocks
    (20, 2, 750, 8),     # two lanes: 320 blocks
    (20, 3, 750, 4),     # three: 240
    (20, 4, 750, 4),     # batched greedy, four windows: 320
    (20, 5, 750, 1),     # five: even 4 would put 400 blocks in flight
    (20, 8, 750, 1),
    (20, 8, 1500, 2),    # long rows: a pair at any batch
    (20, 64, 1200, 2),
    (20, 64, 1199, 1),
    (20, 1, 1500, 8),
    (20, 1, 448, 1),     # a full-context self cache never splits
    (20, 1, 512, 8),
    (20, 1, 511, 1),
    (20, 5, 128, 1),     # the beam self cache
    (20, 1, 1, 1),
    (4, 16, 3000, 4),    # 64 blocks
    (4, 1, 192, 1),
])
def test_k3_lane_split_plan(n_head, n_lane, c_used, splits):
    """K3's per-lane cluster size: 8 or 4 blocks a (head, lane), the larger
    within 320 blocks in flight, from 512 rows on (past the decoder's
    448-row context); past that a pair from 1200 rows on; else the
    one-block kernel."""
    assert KC.plan_lane_splits(n_head, n_lane, c_used) == splits


@pytest.mark.parametrize("m,d,n_sm,ksplit", [
    (750, 1280, 132, 2),    # one large-v2 window: 60 tiles, 120 split
    (705, 1280, 132, 2),    # a clip window
    (1500, 1280, 132, 1),   # two windows: 120 tiles, 240 split
    (3000, 1280, 132, 1),   # four windows: 240 tiles
    (6000, 1280, 132, 1),   # eight: 470 tiles
    (48000, 1280, 132, 1),  # 64 windows: 3750 tiles
    (1, 384, 132, 2),
    (3000, 768, 132, 1),    # 144 tiles: more than a wave unsplit
    (1500, 1280, 264, 2),   # twice the SMs: 240 split blocks fit
])
def test_k2_ksplit_plan(m, d, n_sm, ksplit):
    """K2's GEMM2 split over K: 2 only when the split grid fits in one
    wave of the SMs, else 1."""
    assert KB.plan_ksplit(m, d, n_sm) == ksplit
