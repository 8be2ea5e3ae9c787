"""A small copy of a cell for CPU tests: the published vocabulary, window
and tokens of the cell's configuration at d 384 (head size 64, as
published) over 2 + 2 layers in float32 (the plain path on the CPU, so
that a sound run sits at the reference to rounding), and its traffic over
two short recordings with batches of 2."""

import copy
import dataclasses

from benchmark import harness


def tiny_cell(name: str, depth: int = 16, check_windows: int = 10,
              d: int = 384, layers: int = 2) -> harness.Cell:
    try:
        cell = harness.load_cell(name)
    except KeyError:  # a cell BENCHMARK.json does not list: every metric
        bench = harness._read(harness.ROOT / "BENCHMARK.json")
        cell = harness.make_cell(*name.split(".", 1), 1, bench["end_to_end"],
                                 bench["per_layer"])
    cfg = dict(cell.config, d_model=d, encoder_layers=layers,
               decoder_layers=layers, encoder_attention_heads=d // 64,
               decoder_attention_heads=d // 64, encoder_ffn_dim=4 * d,
               decoder_ffn_dim=4 * d, dtype="float32")
    traffic = copy.deepcopy(cell.traffic)
    traffic["batch_size"] = 2
    traffic["recording_minutes"] = [0.5, 0.8]
    traffic["options"]["max_depth"] = depth
    traffic["check_windows"] = check_windows
    return dataclasses.replace(cell, config=cfg, traffic=traffic)
