"""Mean rows (windows, padding included) of the encoder passes in the
profiled call, from the input shapes of the encoder's first operator, the
mel convolution: (rows, n_mels, frames). A tail is a 1-row pass."""


def read(trace, ctx):
    n_mels = ctx["config"]["num_mel_bins"]
    rows = [s[0] for s in trace.conv_inputs if len(s) == 3 and s[1] == n_mels]
    return sum(rows) / len(rows) if rows else None
