"""The operation and byte counts against values worked out by hand."""

import pytest

from benchmark import counts


def test_k1_one_window():
    # 4 * 750^2 * 1280 operations; q, k, v read and out written in bf16
    n_bytes, flops = counts.flash_attention(1, 750, 750, 1280)
    assert flops == 4 * 750 ** 2 * 1280 == 2.88e9
    assert n_bytes == 4 * 750 * 1280 * 2
    assert counts.bound_s((n_bytes, flops)) * 1e3 == pytest.approx(0.0029, abs=5e-5)


def test_k3_cross_one_window():
    # K and V of 750 rows at d 1280 in bf16: 3.84 MB, bound by bytes
    n_bytes, flops = counts.decode_cross(1, 1, 750, 1280)
    assert n_bytes == 3_840_000 + 2 * 1280 * 2 + 4
    assert flops == 4 * 750 * 1280
    assert counts.bound_s((n_bytes, flops)) * 1e3 == pytest.approx(0.0011, abs=5e-5)


def test_k3g_reads_each_window_once():
    one = counts.decode_cross(5, 1, 750, 1280)[0]
    assert one == 3_840_000 + 5 * (2 * 1280 * 2 + 4)


def test_k2_and_self_and_permute():
    # K2 at one window's 750 rows (chip_smoke.py: bound 0.0199 ms by ops)
    assert counts.bound_s(counts.encoder_mlp(750, 1280, 5120)) * 1e3 == \
        pytest.approx(0.0199, abs=5e-5)
    # a lane at pos 36 reads 37 rows of K and V
    n_bytes, flops = counts.decode_self([37], 1280)
    assert n_bytes == 2 * 37 * 1280 * 2 + 2 * 1280 * 2 + 4
    assert flops == 4 * 37 * 1280
    # beam 5 over one window, 32 layers, 36 valid rows, K and V
    assert counts.permute(5, 1, 32, 36, 1280)[0] == 2 * 6 * 32 * 36 * 1280 * 2


def test_model_flops_large_v2_window():
    cfg = {"d_model": 1280, "vocab_size": 51865, "decoder_layers": 32,
           "decoder_ffn_dim": 5120, "num_mel_bins": 80, "encoder_layers": 32,
           "encoder_ffn_dim": 5120}
    d, s = 1280, 750
    enc = (2 * 3 * 1500 * 80 * d + 2 * 3 * s * d * d
           + 32 * (24 * s * d * d + 4 * s * s * d))
    assert counts.encoder_flops(1500, 80, d, 32, 5120) == enc
    assert enc == pytest.approx(1.04e12, rel=0.01)
    assert counts.cross_kv_flops(s, d, 32) == 32 * 4 * s * d * d
    per_pos = lambda p: 32 * (28 * d * d + 4 * (p + 1) * d + 4 * s * d) + 2 * d * 51865
    greedy = (enc + 32 * 4 * s * d * d + sum(per_pos(p) for p in range(67)))
    assert counts.window_flops(1500, 4, 64, 1, cfg) == pytest.approx(greedy)
    assert greedy == pytest.approx(1.31e12, rel=0.01)


def test_window_frames():
    assert counts.window_frames(238559, 1500, 10) == 1500
    assert counts.window_frames(51182, 1500, 10) == 51182 // 160 + 10
