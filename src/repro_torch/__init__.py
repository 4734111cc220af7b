"""repro_torch — HAlign-II's MSA, tree, search and LM-serving paths on
PyTorch/CUDA.

Mirrors ``src/repro`` path for path. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; on a CUDA tensor the five hand-written
kernels (``kernels.sw``, ``kernels.distance``, ``kernels.banded``,
``kernels.flash_attention``) run, on a CPU tensor their plain PyTorch
versions do.
"""
