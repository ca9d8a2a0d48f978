"""The benchmark harness of the PyTorch/CUDA port (``repro_torch``):
the yardstick of every later change.  ``bench/run.py`` is its command."""
