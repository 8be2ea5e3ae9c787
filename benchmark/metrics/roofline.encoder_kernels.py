"""K1 (flash attention) and K2 (the fused encoder MLP: a LayerNorm kernel
and two GEMM kernels) together: the least time their calls in the
profiled call need (`counts.flash_attention`, `counts.encoder_mlp` at
each encoder pass's shapes, every layer) over their summed device time.

The passes' shapes come from the mel convolution's input (rows, n_mels,
frames); a family with no launch adds neither time nor bound."""

import math
import re

from benchmark import counts

# CUDA symbol names (demangled, as the profiler gives them) -> family
FAMILIES = {
    "K1": [r"\(anonymous namespace\)::flash_attention_kernel\b"],
    "K2": [r"\(anonymous namespace\)::layer_norm_kernel\b",
           r"\(anonymous namespace\)::mlp_gemm_kernel\b"],
}


def read(trace, ctx):
    cfg = ctx["config"]
    d, layers = cfg["d_model"], cfg["encoder_layers"]
    passes = [s for s in trace.conv_inputs
              if len(s) == 3 and s[1] == cfg["num_mel_bins"]]
    bound = time_ns = 0.0
    for family, names in FAMILIES.items():
        n, ns = trace.kernel_ns([re.compile(p) for p in names])
        if not n:
            continue
        time_ns += ns
        for rows, _, frames in passes:
            s = math.ceil(frames / 2)
            work = (counts.flash_attention(rows, s, s, d) if family == "K1"
                    else counts.encoder_mlp(rows * s, d, cfg["encoder_ffn_dim"]))
            bound += layers * counts.bound_s(work)
    if not time_ns or not passes:
        return None
    return 100.0 * bound / (time_ns / 1e9)
