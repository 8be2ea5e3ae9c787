"""Checkpoints: the port's copy of `whisper_tpu/io/checkpoint.py`. Its
loaders return, and its writer takes, the parameter tree as nested dicts
of numpy arrays (the JAX package's keys and layouts; `params.
from_numpy_tree` turns it into the port's ParamTree).

The reference's fast-load format is Burn's `.mpk.gz` record plus a `.cfg`
JSON written by its convert CLI (src/bin/convert/main.rs:17-19,45,51). The
TPU-native equivalent here is a flat safetensors file (zero-copy mmap,
dtype-preserving) plus the same `.cfg` JSON schema, so `convert` produces
`<name>.safetensors` + `<name>.cfg` and `transcribe` starts instantly.

`load_params` is the one-stop loader: it accepts a dump-tree directory
(reference npy format), a `.safetensors` file, or a Burn `.mpk.gz` record,
and returns (params pytree, config).
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..config import WhisperConfig
from . import npy_tree

Params = Dict[str, Any]


# ----------------------------------------------------------------------------
# Flat key <-> pytree mapping
# ----------------------------------------------------------------------------


def flatten_params(params: Params, prefix: str = "") -> Dict[str, np.ndarray]:
    """{"encoder.conv1_w": array, ...}, every array C-contiguous: the
    safetensors writer (0.4 on) copies an array's buffer as it lies in
    memory, so a transposed view -- the conv weights of a dump tree, the
    linears of `convert_pt` -- would be written with its elements out of
    order. The JAX package's `flatten_params` keeps views (`np.asarray`),
    and its `convert` writes such files under those versions."""
    flat: Dict[str, np.ndarray] = {}
    for k, v in params.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(flatten_params(v, key + "."))
        else:
            flat[key] = np.ascontiguousarray(v)
    return flat


def unflatten_params(flat: Dict[str, np.ndarray]) -> Params:
    tree: Params = {}
    for key, v in flat.items():
        parts = key.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


# ----------------------------------------------------------------------------
# safetensors
# ----------------------------------------------------------------------------


def save_safetensors(params: Params, cfg: WhisperConfig, path: str) -> None:
    """Write the numpy tree as one flat safetensors file with the `.cfg`
    JSON in its metadata: the bytes the JAX package's writer gives for
    C-contiguous leaves (`flatten_params`)."""
    from safetensors.numpy import save_file

    save_file(flatten_params(params), path,
              metadata={"config": json.dumps(cfg.to_cfg_dict())})


def load_safetensors(path: str) -> Tuple[Params, Optional[WhisperConfig]]:
    from safetensors import safe_open

    flat: Dict[str, np.ndarray] = {}
    cfg = None
    with safe_open(path, framework="numpy") as f:
        meta = f.metadata()
        if meta and "config" in meta:
            cfg = WhisperConfig.from_cfg_dict(json.loads(meta["config"]))
        for key in f.keys():
            flat[key] = f.get_tensor(key)
    return unflatten_params(flat), cfg


# ----------------------------------------------------------------------------
# Unified entry
# ----------------------------------------------------------------------------


def load_params(path: str, cfg: Optional[WhisperConfig] = None) -> Tuple[Params, WhisperConfig]:
    """Load weights from any supported source.

    path may be:
      * a directory  -> reference npy dump tree (python/dump.py format)
      * *.safetensors -> native format (config embedded in metadata)
      * *.mpk.gz / *.mpk -> Burn record (requires cfg or a sibling .cfg file)
      * a bare model name -> tries <name>.safetensors, then <name>.mpk.gz,
        then <name>/ as a dump tree (mirroring the reference CLI's
        `<model name>` argument convention, src/bin/transcribe/main.rs:63-70)
    """
    if os.path.isdir(path):
        return npy_tree.load_whisper(path)
    if path.endswith(".safetensors"):
        params, meta_cfg = load_safetensors(path)
        final = cfg or meta_cfg
        if final is None:
            raise ValueError(f"{path}: no config in metadata; pass cfg explicitly")
        return params, final
    if path.endswith((".mpk.gz", ".mpk")):
        from . import mpk

        if cfg is None:
            cfg_path = re.sub(r"\.mpk(\.gz)?$", "", path) + ".cfg"
            if os.path.exists(cfg_path):
                cfg = WhisperConfig.load(cfg_path)
        return mpk.load_whisper_record(path, cfg)

    # bare model name
    for candidate in (path + ".safetensors", path + ".mpk.gz", path):
        if os.path.exists(candidate):
            if candidate != path or os.path.isdir(candidate):
                sibling_cfg = path + ".cfg"
                if cfg is None and os.path.exists(sibling_cfg):
                    cfg = WhisperConfig.load(sibling_cfg)
                return load_params(candidate, cfg)
    raise FileNotFoundError(f"no checkpoint found for {path!r}")
