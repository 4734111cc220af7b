"""Match/valid count kernel: ``ops.match_valid`` (wrapper), ``ref`` (plain)."""
