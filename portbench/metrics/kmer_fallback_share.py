"""Share of the non-center sequences whose k-mer chain failed and went
to the full DP (the program's ``n_fallback`` count), in %."""


def read(ctx):
    pairs = sum(r["units"] - 1 for r in ctx.records)
    if not pairs:
        return None
    return 100.0 * sum(r["n_fallback"] for r in ctx.records) / pairs
