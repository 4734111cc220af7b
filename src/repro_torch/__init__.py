"""repro_torch — HAlign-II's center-star MSA and NJ pipeline on PyTorch/CUDA.

Mirrors ``src/repro`` path for path. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; on a CUDA tensor the two hand-written
kernels (``kernels.sw`` Gotoh forward, ``kernels.distance`` match/valid
counts) run, on a CPU tensor their plain PyTorch versions do.
"""
