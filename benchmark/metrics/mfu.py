"""The whole run's share of the card's bf16 peak: the useful operations
of every real window that the measured window decoded
(`counts.window_flops`: the encoder, the cross K/V, the prompt once and
every S = 1 step of every lane; padding rows are not counted) over the
window's wall time, at 989 TFLOP/s."""

from benchmark import counts


def read(trace, ctx):
    flops, wall = trace.call["window_flops"], trace.call["window_wall_s"]
    if not flops or not wall:
        return None
    return 100.0 * flops / (wall * counts.PEAK_BF16_FLOPS)
