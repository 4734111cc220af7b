"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

  sw         Gotoh forward (``csrc/sw_forward.cu``), replacing the TPU
             kernel ``repro/kernels/sw/sw_kernel.py::gotoh_forward_kernel``
  distance   match/valid counts (``csrc/match_valid.cu``), replacing
             ``repro/kernels/distance/distance_kernel.py::match_valid_kernel``

``_build`` compiles the sources with nvcc on first use and loads them
with ctypes.
"""
