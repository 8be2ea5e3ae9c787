"""Random Whisper weights from a seed, made on the device in one draw.

The tree has the layout the program under test takes (its `ParamTree`
over nested dicts): per-layer tensors stacked on a leading layer axis,
matrices stored (in, out), the fused QKV (d, 3, d) and cross KV (d, 2, d)
projections, conv weights (kernel, in, out). Every leaf is a view into
one flat buffer in the served dtype, filled by ONE `normal_` call from a
generator on the device seeded from `--seed`, then scaled in place by
kind. The same seed gives the same weights, so the reference makes its
own copy after the program has been freed.

The scales make the answers depend on the audio, so that a window
answered with another window's tokens is wrong: at one scale for every
weight, a random decoder repeats its input token (the tied embedding
scores itself highest) and every window decodes alike. Here the encoder's
positional embedding is small against the audio's convolution output,
the cross-attention projections are larger than the other weights (a
sharp, strong look at the audio; N(0, 1.75 / sqrt(d)), so that their
scores have the same spread at every width: at d 1280 a larger scale
makes some seeds attend one frame of every window and decode alike), and
the token embedding is at the weights' scale, so the layers and not the
input token steer each step.

The EOT row of the tied token embedding is zero: the EOT logit is then
exactly 0, below thousands of others, and every window decodes the
traffic's full depth whatever the audio.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

SCALES = {"w": 0.02, "b": 0.02, "emb": 1.0, "gain": 0.1, "ln_b": 0.02,
          "audio_pos": 0.1, "tok": 0.02}
CROSS = 1.75  # the cross-attention projections' scale is CROSS / sqrt(d)


def _blocks(n: int, d: int, ffn: int, cross: bool) -> Dict[str, tuple]:
    p = {
        "attn_ln_g": ((n, d), "gain"), "attn_ln_b": ((n, d), "ln_b"),
        "qkv_w": ((n, d, 3, d), "w"), "qkv_b": ((n, 3, d), "b"),
        "attn_o_w": ((n, d, d), "w"), "attn_o_b": ((n, d), "b"),
        "mlp_ln_g": ((n, d), "gain"), "mlp_ln_b": ((n, d), "ln_b"),
        "mlp1_w": ((n, d, ffn), "w"), "mlp1_b": ((n, ffn), "b"),
        "mlp2_w": ((n, ffn, d), "w"), "mlp2_b": ((n, d), "b"),
    }
    if cross:
        p.update({
            "cross_ln_g": ((n, d), "gain"), "cross_ln_b": ((n, d), "ln_b"),
            "cross_q_w": ((n, d, d), "cross"), "cross_q_b": ((n, d), "b"),
            "cross_kv_w": ((n, d, 2, d), "cross"), "cross_kv_b": ((n, 2, d), "b"),
            "cross_o_w": ((n, d, d), "w"), "cross_o_b": ((n, d), "b"),
        })
    return p


def layout(cfg: Dict) -> Dict:
    """{name: (shape, kind)} nested as the tree, from a configuration
    file's published sizes."""
    d = cfg["d_model"]
    return {
        "encoder": {
            "conv1_w": ((3, cfg["num_mel_bins"], d), "w"), "conv1_b": ((d,), "b"),
            "conv2_w": ((3, d, d), "w"), "conv2_b": ((d,), "b"),
            "pos_emb": ((cfg["max_source_positions"], d), "audio_pos"),
            "blocks": _blocks(cfg["encoder_layers"], d, cfg["encoder_ffn_dim"],
                              cross=False),
            "ln_post_g": ((d,), "gain"), "ln_post_b": ((d,), "ln_b"),
        },
        "decoder": {
            "tok_emb": ((cfg["vocab_size"], d), "tok"),
            "pos_emb": ((cfg["max_target_positions"], d), "emb"),
            "blocks": _blocks(cfg["decoder_layers"], d, cfg["decoder_ffn_dim"],
                              cross=True),
            "ln_g": ((d,), "gain"), "ln_b": ((d,), "ln_b"),
        },
    }


def _leaves(tree: Dict, prefix: Tuple = ()) -> List[Tuple[Tuple, tuple, str]]:
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _leaves(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v[0], v[1]))
    return out


def derived_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for one use (`stream`) of a run's seed."""
    state = np.random.SeedSequence([int(seed) % 2 ** 63, stream])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def make_weights(cfg: Dict, seed: int, device, dtype=None) -> Dict:
    """The nested dict of weights for a configuration file, on `device`,
    in the configuration's dtype unless `dtype` is given."""
    dtype = dtype or getattr(torch, cfg["dtype"])
    leaves = _leaves(layout(cfg))
    scales = dict(SCALES, cross=CROSS / cfg["d_model"] ** 0.5)
    total = sum(int(np.prod(shape)) for _, shape, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, 0))
    flat = torch.empty(total, dtype=dtype, device=device)
    flat.normal_(generator=gen)
    tree: Dict = {}
    off = 0
    for path, shape, kind in leaves:
        n = int(np.prod(shape))
        t = flat[off:off + n].view(shape)
        off += n
        t.mul_(scales[kind])
        if kind == "gain":
            t.add_(1.0)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    tree["decoder"]["tok_emb"][cfg["tokens"]["eot"]].zero_()
    return tree
