"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

  sw               Gotoh forward (``csrc/sw_forward.cu``), replacing the
                   TPU kernel ``repro/kernels/sw/sw_kernel.py::
                   gotoh_forward_kernel``
  distance         match/valid counts (``csrc/match_valid.cu``), replacing
                   ``repro/kernels/distance/distance_kernel.py::
                   match_valid_kernel``
  banded           banded Gotoh forward (``csrc/banded_forward.cu``) and
                   fused banded forward + traceback
                   (``csrc/banded_fused.cu``), replacing
                   ``repro/kernels/banded/banded_kernel.py::
                   banded_forward_kernel`` and ``banded_fused_kernel``
  flash_attention  blocked online-softmax attention
                   (``csrc/flash_attention.cu``), replacing
                   ``repro/kernels/flash_attention/flash_kernel.py::
                   flash_attention_kernel``

``_build`` compiles the sources with nvcc on first use and loads them
with ctypes.
"""
