"""The benchmark of whisper_tpu_torch (the PyTorch and CUDA port): one
command, `python3 benchmark/run.py`, that BENCHMARK.json at the root of
the repository drives. Nothing here imports jax or the JAX package."""
