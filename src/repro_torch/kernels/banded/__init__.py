"""Banded Gotoh: the forward kernel (``csrc/banded_forward.cu``) and the
fused score+traceback kernel (``csrc/banded_fused.cu``), wrapped by
``ops``; ``ref`` holds their plain PyTorch version, the band math the
port's ``align.banded`` also runs."""
