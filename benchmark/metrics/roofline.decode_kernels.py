"""The decode attention kernels (K3 over the self and cross caches, K3g
over a cross cache shared by a window's beam lanes) and K4 (the beam
reshuffle of the self caches) together: the least time of their calls in
the profiled call over their summed device time.

Each encoder pass (rows windows, frames from the mel convolution's
input) is followed by `max_depth - 1` S = 1 decoder steps over its lanes
(one a window, or beam_size), at positions prompt .. prompt + depth - 2,
every layer: K3 self reads each lane's rows [0, pos]
(`counts.decode_self`), the cross kernel each window's whole cache once
(`counts.decode_cross`), and under beam search K4 the valid rows [0, pos)
of every layer of the lanes' slabs (`counts.permute`). A family with no
launch adds neither time nor bound."""

import math
import re

from benchmark import counts

# CUDA symbol names (demangled, as the profiler gives them) -> family
FAMILIES = {
    "K3": [r"\(anonymous namespace\)::decode_attention_kernel\b",
           r"\(anonymous namespace\)::decode_attention_group_kernel\b"],
    "K4": [r"\(anonymous namespace\)::permute_kernel\b"],
}


def read(trace, ctx):
    cfg, opt = ctx["config"], ctx["traffic"]["options"]
    d, layers = cfg["d_model"], cfg["decoder_layers"]
    beam = opt["strategy"] == "beam"
    k = opt["beam_size"] if beam else 1
    prompt, depth = ctx["prompt_len"], opt["max_depth"]
    passes = [s for s in trace.conv_inputs
              if len(s) == 3 and s[1] == cfg["num_mel_bins"]]
    bound = time_ns = 0.0
    for family, names in FAMILIES.items():
        n, ns = trace.kernel_ns([re.compile(p) for p in names])
        if not n:
            continue
        time_ns += ns
        for rows, _, frames in passes:
            sa, lanes = math.ceil(frames / 2), rows * k
            for pos in range(prompt, prompt + depth - 1):
                if family == "K3":
                    bound += layers * (
                        counts.bound_s(counts.decode_self([pos + 1] * lanes, d))
                        + counts.bound_s(counts.decode_cross(lanes, rows, sa, d)))
                elif beam:
                    bound += counts.bound_s(
                        counts.permute(lanes, rows, layers, pos, d))
    if not time_ns or not passes:
        return None
    return 100.0 * bound / (time_ns / 1e9)
