"""Gotoh forward kernel: ``ops.gotoh_forward`` (wrapper), ``ref`` (plain)."""
