"""trackformer_tpu_torch: the PyTorch + CUDA port of trackformer_tpu.

The JAX package `trackformer_tpu` is the reference this port is held
against; module paths match it (`ops/msda.py`, `models/backbone.py`,
`tracking/tracker.py`, ...). This package imports torch and numpy only.
Importing it builds nothing: the CUDA kernel under `csrc/` is compiled at
its first launch.
"""
