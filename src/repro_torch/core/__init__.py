"""HAlign-II core on PyTorch: center-star MSA, k-mer index, NJ, SP score."""
