"""The plain float32 reference of the benchmark: Whisper written out in
plain PyTorch (and the splice of overlapping windows), with no kernel
and no batching logic of the program under test, and no import of it."""
