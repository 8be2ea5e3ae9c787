"""The traffic generator: the same schedule and windows for every seed,
different audio between seeds, and the window, tail and padding counts."""

import torch

from benchmark import harness
from benchmark import traffic as tr


def cell(name="large-v3-turbo.archive-greedy"):
    return harness.load_cell(name)


def test_geometry_is_the_reference_window():
    c = cell()
    geo = tr.geometry(c.config, c.traffic)
    assert geo.window == 160 * 1491 - 1 == 238559  # 14.91 s
    assert geo.shift == geo.window - 3 * 16000


def test_schedule_is_data():
    c = cell()
    assert tr.rotation(c.traffic) == [(m * 60 * 16000,)
                                      for m in [60, 90, 120, 150, 180]]


def test_window_counts_of_an_hour():
    c = cell()
    geo = tr.geometry(c.config, c.traffic)
    n = 3600 * 16000
    wins = tr.windows(n, geo)
    assert len(wins) == 303
    assert all(e - s == geo.window for s, e in wins[:-1])
    assert wins[-1] == (302 * geo.shift, n)  # a 3.2 s tail
    assert tr.window_counts([n], geo, 128) == {"full": 302, "tails": 1,
                                               "padding": 82}
    # a remnant under one STFT frame (400 samples) is not decoded
    assert tr.windows(geo.shift + 300, geo) == [(0, geo.shift + 300)]
    assert tr.windows(geo.shift + 400, geo)[-1] == (geo.shift, geo.shift + 400)


def test_rotation_work_of_each_cell():
    # the 30 min recording ends in two partial windows
    for name, batches, tails in (("large-v3-turbo.archive-greedy", 26, 5),
                                 ("large-v3-turbo.archive-beam5", 26, 6),
                                 ("large-v2.archive-beam5", 26, 6)):
        c = harness.make_cell(*name.split(".", 1))
        geo = tr.geometry(c.config, c.traffic)
        b = c.traffic["batch_size"]
        counts = [tr.window_counts(lengths, geo, b)
                  for lengths in tr.rotation(c.traffic)]
        assert sum((k["full"] + k["padding"]) // b for k in counts) == batches
        assert sum(k["tails"] for k in counts) == tails


def test_audio_is_seeded():
    a = tr.audio(50000, 2 ** 31 + 11, 3, 0, "cpu")
    b = tr.audio(50000, 2 ** 31 + 11, 3, 0, "cpu")
    c = tr.audio(50000, 2 ** 31 + 12, 3, 0, "cpu")
    d = tr.audio(50000, 2 ** 31 + 11, 4, 0, "cpu")
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)
    assert a.dtype == torch.float32 and float(a.abs().max()) < 1.5


def test_warmup_covers_each_shape_once():
    c = cell()
    geo = tr.geometry(c.config, c.traffic)
    warm = harness.warmup_lengths(c.traffic, geo)
    full = tr.window_counts([warm[0]], geo, 128)
    assert full["full"] == 128 and full["padding"] == 0
    want = set()
    for lengths in tr.rotation(c.traffic):
        for n in lengths:
            want |= {e - s for s, e in tr.windows(n, geo) if e - s < geo.window}
    got = set()
    for n in warm[1:]:
        wins = tr.windows(n, geo)
        assert all(e - s < geo.window for s, e in wins)  # tails only
        got |= {e - s for s, e in wins}
    assert got == want
