"""whisper_tpu_torch: the PyTorch/CUDA port of whisper_tpu for NVIDIA Hopper.

The JAX package `whisper_tpu` stays the reference. This package imports
torch and never jax, and nothing of `whisper_tpu`: it keeps its own copies
of the jax-free parts it needs (config, tokenizer, io, vad, the WER
harness and its text normalizers). Its hand-written CUDA kernels build at
first use (ops/kernels/_build.py), never at import.
"""

__version__ = "0.1.0"

from .config import WhisperConfig, preset, tiny_test_config

__all__ = ["WhisperConfig", "preset", "tiny_test_config"]
