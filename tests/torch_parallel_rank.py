"""The rank side of tests/test_torch_parallel.py: what one SPMD rank runs.

Torch only: a rank process imports this module and the port, never JAX
(`run_case` checks). The parent passes a case dict (numpy params, audio,
options) and compares what the ranks return with JAX's meshless outputs
and with the meshless port.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import numpy as np
import torch


def _port_modules():
    from whisper_tpu_torch import config
    from whisper_tpu_torch.models import whisper as M
    from whisper_tpu_torch.parallel import context, mesh, sharding
    from whisper_tpu_torch.params import from_numpy_tree, numpy_tree
    from whisper_tpu_torch.pipeline import batch, transcribe
    from whisper_tpu_torch.text.tokenizer import WhisperTokenizer
    from whisper_tpu_torch.training import checkpointing, train
    return dict(config=config, M=M, context=context, mesh=mesh,
                sharding=sharding, from_numpy_tree=from_numpy_tree,
                numpy_tree=numpy_tree, batch=batch, transcribe=transcribe,
                Tokenizer=WhisperTokenizer, checkpointing=checkpointing,
                train=train)


def decode_all(case: dict, mesh=None) -> dict:
    """Every decode of `case` through the Transcriber and the
    BatchTranscriber, meshed over `mesh` or meshless: {name: tokens of
    the stream, or per stream}."""
    m = _port_modules()
    cfg = m["config"].tiny_test_config(**case["dims"])
    tok = m["Tokenizer"](case["tok"])
    T, B = m["transcribe"], m["batch"]
    out = {}
    tr = T.Transcriber(case["params"], cfg, tok, device="cpu",
                       attention="flash", mesh=mesh)
    for name, kw in case["single"].items():
        out[f"single_{name}"] = tr.transcribe(case["wave"], 16000,
                                              T.DecodeOptions(**kw))[1]
    bt = B.BatchTranscriber(case["params"], cfg, tok, device="cpu",
                            attention="flash", mesh=mesh,
                            batch_size=case["batch_size"])
    out["batch_size"] = bt.batch_size
    for name, kw in case["many"].items():
        res = bt.transcribe_many(case["waves"], 16000, T.DecodeOptions(**kw))
        out[f"many_{name}"] = [toks for _, toks in res]
    return out


def scale_checks(case: dict, mesh=None) -> dict:
    """The quantization scales a mesh must not change: the cross cache's
    (layer, channel) scales over a batch of windows of different loudness
    (split over dp under a mesh: its dp MAX), and the self cache's row
    scales after a prefill (its channels split over tp: its tp MAX)."""
    m = _port_modules()
    M, ctx = m["M"], m["context"]
    cfg = m["config"].tiny_test_config(**case["dims"])
    params = m["from_numpy_tree"](case["params"])
    if mesh is not None:
        params = m["sharding"].shard_params(params, mesh, cfg)
    enc = torch.from_numpy(case["enc"])
    tokens = torch.from_numpy(case["prompt"])[None].repeat(len(enc), 1)
    b = n = len(enc)
    first, split = 0, mesh is not None and ctx.dp_axis(mesh, b) is not None
    if split:
        n = b // mesh.shape["dp"]
        first = mesh.dp_rank * n
    rows = ctx.dp_rows(first, b) if split else contextlib.nullcontext()
    with ctx.kernel_mesh(mesh), rows, torch.inference_mode():
        cache = M.init_cache(params, enc[first:first + n], cfg,
                             kv_quant="int8", self_quant="int8",
                             cache_len=16)
        M.decoder_step(params, tokens[first:first + n], 0, cache, cfg)
    p = tokens.shape[1]
    return {"cross_k_scale": cache.cross_k.scale.numpy(),
            "cross_v_scale": cache.cross_v.scale.numpy(),
            "self_k_rows": cache.self_k.scale[:, :, :p].numpy(),
            "self_v_rows": cache.self_v.scale[:, :, :p].numpy(),
            "first": first}


def train_and_save(case: dict, mesh=None) -> dict:
    """Two train steps from the case's params over `mesh` (or meshless),
    each step's metrics, the params gathered after them; a save of the
    fresh state (`save_dir/fresh.pt`) and, after the steps, a save, a
    restore into a fresh sharded state, and whether the restore gave back
    this rank's shards exactly."""
    m = _port_modules()
    tr, ck, sh = m["train"], m["checkpointing"], m["sharding"]
    cfg = m["config"].tiny_test_config(**case["dims"])
    opt = tr.make_optimizer(**case["opt"])
    from whisper_tpu_torch.params import trainable

    params = trainable(case["params"])
    if mesh is not None:
        params = sh.shard_params(params, mesh, cfg)
    state = tr.init_train_state(params, opt)
    ck.save_train_state(os.path.join(case["save_dir"], "fresh.pt"), state,
                        mesh=mesh, cfg=cfg)
    step = tr.make_train_step(cfg, opt, remat=case["remat"], mesh=mesh)
    batch = tr.Batch(*(torch.from_numpy(x) for x in case["batch"]))
    metrics = []
    for _ in range(case["steps"]):
        state, mt = step(state, batch)
        metrics.append({k: float(v) for k, v in mt.items()})
    path = os.path.join(case["save_dir"], "after.pt")
    ck.save_train_state(path, state, mesh=mesh, cfg=cfg)
    fresh = tr.init_train_state(
        sh.shard_params(trainable(case["params"]), mesh, cfg)
        if mesh is not None else trainable(case["params"]), opt)
    back = ck.restore_train_state(path, fresh, mesh=mesh, cfg=cfg)
    restored = all(
        torch.equal(a, b) for (_, a), (_, b) in zip(
            back.params.named_parameters(), state.params.named_parameters()))
    restored &= all(torch.equal(back.opt_state.mu[n], state.opt_state.mu[n])
                    for n in state.opt_state.mu)
    whole = (sh.gather_params(state.params, mesh, cfg) if mesh is not None
             else state.params)
    return {"metrics": metrics, "params": m["numpy_tree"](whole),
            "restored": bool(restored), "step": back.step}


def fail_or_hang(rank: int) -> None:
    """Rank 1 raises at once; rank 0 hangs, as a rank left waiting for a
    dead peer would (test_failed_rank_stops_the_run)."""
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    time.sleep(600)


def run_case(rank: int, case: dict) -> dict:
    """One rank: for each mesh of `case["meshes"]` ({name: (dp, tp)}, each
    over the whole world, one after the other), every check; returns
    {name: outputs}. The saves of a mesh go to `save_dir/name`."""
    if "jax" in sys.modules or "whisper_tpu" in sys.modules:
        raise AssertionError("a rank process imported JAX or whisper_tpu")
    m = _port_modules()
    outs = {}
    for name, (dp, tp) in case["meshes"].items():
        mesh = m["mesh"].make_mesh(dp=dp, tp=tp)
        save_dir = os.path.join(case["save_dir"], name)
        os.makedirs(save_dir, exist_ok=True)
        c = dict(case, save_dir=save_dir)
        outs[name] = {"rank": rank, "dp_rank": mesh.dp_rank,
                      "tp_rank": mesh.tp_rank,
                      "threads": torch.get_num_threads(),
                      "decode": decode_all(c, mesh),
                      "scales": scale_checks(c, mesh),
                      "train": train_and_save(c, mesh),
                      "jax_imported": "jax" in sys.modules}
    return outs


def first_step(tr, window: np.ndarray, opts) -> tuple:
    """(the window's encoder output, the logits of the first S=1 step after
    the prompt's prefill) through `tr`'s path and mesh, as f32 numpy."""
    M, ctx = _port_modules()["M"], _port_modules()["context"]
    with ctx.kernel_mesh(tr.mesh), torch.inference_mode():
        enc = tr._encode_windows(window[None], opts)
        prompt, _ = tr._build_prompt(opts)
        cache = M.init_cache(tr.params, enc, tr.cfg, cache_len=128,
                             kv_quant=opts.kv_quant,
                             self_quant=opts.self_quant)
        logits, cache = M.decoder_step(tr.params, prompt[None], 0, cache,
                                       tr.cfg)
        tok = logits[:, -1].argmax(-1)
        logits, _ = M.decoder_step(tr.params, tok[:, None], len(prompt),
                                   cache, tr.cfg)
    return (enc.float().cpu().numpy(), logits[:, -1].float().cpu().numpy())


def cuda_transcriber(case: dict, mesh=None):
    """The Transcriber of the GPU case on the card: bf16 random weights
    from the case's seed, the kernels (attention "flash")."""
    m = _port_modules()
    from whisper_tpu_torch.params import init_params

    cfg = m["config"].tiny_test_config(**case["dims"])
    gen = torch.Generator(device="cuda").manual_seed(case["seed"])
    params = init_params(cfg, gen, dtype=torch.bfloat16)
    return m["transcribe"].Transcriber(params, cfg, m["Tokenizer"](
        case["tok"]), mesh=mesh)


def run_cuda_case(rank: int, case: dict) -> dict:
    """One rank of the GPU case: a tp mesh on cuda:0 (gloo), the first step
    of a window through the kernels at the local head count, then greedy
    over the stream; the launch counts of the kernels."""
    from whisper_tpu_torch.ops.kernels import decode_attention as KC
    from whisper_tpu_torch.ops.kernels import encoder_block as KB
    from whisper_tpu_torch.ops.kernels import flash_attention as KA

    m = _port_modules()
    mesh = m["mesh"].make_mesh(dp=1, tp=case["tp"])
    tr = cuda_transcriber(case, mesh)
    opts = m["transcribe"].DecodeOptions(**case["opts"])
    counters = ((KA.attention_bhsd, "launches"),
                (KB.fused_mlp_block, "launches"),
                (KC.decode_attention_stacked, "launches"))
    for fn, attr in counters:
        setattr(fn, attr, 0)
    enc, logits = first_step(tr, case["window"], opts)
    tokens = tr.transcribe(case["wave"], 16000, opts)[1]
    torch.cuda.synchronize()
    return {"enc": enc, "logits": logits, "tokens": tokens,
            "launches": [getattr(fn, attr) for fn, attr in counters],
            "device": str(tr.device)}
