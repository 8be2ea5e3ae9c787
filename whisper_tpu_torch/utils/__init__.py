"""See the package docstring of whisper_tpu_torch."""
