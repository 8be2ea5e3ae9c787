"""Build and load the port's hand-written CUDA kernels.

Each source in `whisper_tpu_torch/csrc/` compiles with `nvcc` for Hopper
(`sm_90a`) into an object file, all of them at once in parallel processes,
and the objects link into ONE shared library with a plain C interface,
loaded with `ctypes`. The library links against the CUDA runtime alone:
the TMA kernels get libcuda's `cuTensorMapEncodeTiled` through
`cudaGetDriverEntryPoint*` at run time, so no `-lcuda` is needed.
Nothing here runs at import time: `library()` builds at first use, so
importing the package on a machine without `nvcc` or a GPU compiles and
loads nothing.

The library lands in `build/whisper_tpu_torch/` at the repository root,
named by a hash of the sources and flags, so an edit to any source builds
a new library and an unchanged tree reuses the old one. A missing `nvcc`
or a failed compile raises with the compiler's output; there is no
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "whisper_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# argtypes of every C entry point (pointers and the stream as c_void_p, so
# ctypes never truncates them to 32 bits).
SIGNATURES = {
    "wtt_flash_attention": [_P] * 4 + [_I] * 5 + [_LL] * 12 + [_F, _P],
    "wtt_encoder_mlp": [_P] * 10 + [_I] * 4 + [_F, _P],
    "wtt_decode_attention": [_P, _P, _P, _P, _I, _P, _P, _P] + [_I] * 9 + [_LL] * 10 + [_P],
    "wtt_permute_attention": [_P] * 17 + [_I] * 7 + [_LL] * 9 + [_P],
    "wtt_permute_lanes": [_I, _I, _P, _P, _P, _P, _P],
    "wtt_w8a8_matmul": [_P] * 7 + [_I] * 10 + [_P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of the last compile


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the "
            "whisper_tpu_torch CUDA kernels are built from source at first use"
        )
    return found


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libwtt_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds) -> list:
    """Run the commands as parallel processes; (cmd, returncode, output)
    for each, in order."""
    logs = [tempfile.TemporaryFile(mode="w+") for _ in cmds]
    procs = [subprocess.Popen(c, stdout=f, stderr=subprocess.STDOUT)
             for c, f in zip(cmds, logs)]
    runs = []
    for c, p, f in zip(cmds, procs, logs):
        rc = p.wait()
        f.seek(0)
        runs.append((c, rc, f.read()))
        f.close()
    return runs


def _compile(out: Path) -> None:
    global build_seconds
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as objdir:
        cus = [p for p in _sources() if p.suffix == ".cu"]
        objs = [str(Path(objdir) / f"{p.stem}.o") for p in cus]
        runs = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(p), "-o", o]
                         for p, o in zip(cus, objs)])
        if all(rc == 0 for _, rc, _ in runs):
            runs += _run_all([[nvcc, "-shared", "-o", str(tmp), *objs]])
    build_seconds = time.perf_counter() - t0
    log = "".join(" ".join(c) + "\n" + o for c, _, o in runs)
    out.with_suffix(".log").write_text(log)
    failed = [rc for _, rc, _ in runs if rc != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def library() -> ctypes.CDLL:
    """The kernels' library, compiled first if the sources changed."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error (e.g. a refused launch)."""
    if err == 1:  # cudaErrorInvalidValue: the entry refused the shapes
        raise ValueError(f"{name}: shapes the kernel does not take "
                         "(cudaErrorInvalidValue, nothing launched)")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} (cudaError_t)")


def refuse_grad(name: str, *tensors) -> None:
    """Raise RuntimeError where autograd would record a launch: when grad
    mode is on and a floating input requires grad. The kernels write
    `torch.empty` outputs through ctypes, so autograd would see no
    `grad_fn` and every weight below the launch would get a zero or
    missing gradient. No kernel has a backward (nor has any TPU kernel a
    VJP in the JAX package), so training runs the plain path
    (attention="xla"); the serving paths run under `inference_mode`."""
    import torch

    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward and cannot run on "
            "inputs that require grad; call it under torch.no_grad() or "
            "train with attention='xla' (the plain path)")


def stream_ptr(t) -> int:
    """The current CUDA stream of tensor `t`'s device, as a raw pointer.
    The raw query skips the Stream object that `torch.cuda.current_stream`
    builds on every call; the decode step asks 64 times a token."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())
