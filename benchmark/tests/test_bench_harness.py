"""The harness builds what the data names: a configuration's `quantize`,
`knobs` and `options` reach the program, and a traffic mix that drives
another entry brings its own `traffic/<name>.py`, found by name."""

import dataclasses

import pytest

from bench_tiny import tiny_cell
from benchmark import check, harness
from benchmark import traffic as tr


def test_configuration_builds_the_program_it_states(tmp_path):
    from whisper_tpu_torch.quantize import QTensor

    cell = tiny_cell("large-v3-turbo.archive-beam5", depth=4, d=128, layers=1)
    cell.config.update(quantize={"bits": 8, "encoder": True},
                       knobs={"int8_impl": "pallas"},
                       options={"kv_quant": "int8", "self_quant": "int8"})
    program = harness.Program(cell, 5, "cpu", tmp_path)
    t = program.transcriber
    for part in ("encoder", "decoder"):
        assert isinstance(t.params[part]["blocks"]["qkv_w"], QTensor)
    assert t.cfg.knobs.int8_impl == "pallas"
    assert program.options.kv_quant == program.options.self_quant == "int8"
    assert program.options.beam_size == 5  # the traffic's, kept
    n = 2 * tr.geometry(cell.config, cell.traffic).window
    record = harness.timed_call(program, tr.Call(0, (n,)), 5, "cpu")
    assert record.error is None and len(record.windows[0]) == 3
    assert check.split_calls([record], cell.config, cell.traffic)[1:] == (0, 0)


def test_traffic_module_supplies_the_entry(tmp_path, monkeypatch):
    cell = dataclasses.replace(tiny_cell("large-v3-turbo.archive-greedy"),
                               traffic_name="other-entry")
    assert harness.entry(cell) == (harness.Program, check.judge)
    cell.traffic = dict(cell.traffic, entry="StreamDecodeBatcher.decode")
    with pytest.raises(ValueError, match="traffic/other-entry.py"):
        harness.entry(cell)
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "other-entry.py").write_text(
        "class Program:\n    pass\n\n\ndef judge(*args):\n    return None\n")
    monkeypatch.setattr(harness, "HERE", tmp_path)
    program_cls, judge = harness.entry(cell)
    assert program_cls.__name__ == "Program" and judge() is None
