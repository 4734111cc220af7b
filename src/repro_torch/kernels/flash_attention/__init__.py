"""Flash attention: the kernel (``csrc/flash_attention.cu``) wrapped by
``ops`` (``attention`` in the LM's (B, S, H, D) layout, the reference's
``flash_attention`` in (B, H, S, D)); ``ref`` holds its plain versions."""
