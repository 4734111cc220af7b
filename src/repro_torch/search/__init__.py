"""repro_torch.search — batched query-vs-database homology search.

``SearchIndex`` (encode a FASTA database once, per-row k-mer tables,
atomic persistence readable by both packages), ``SearchEngine`` (seed
prefilter on the device + ``AlignEngine.align_pairs`` rescoring +
e-value/coverage gates) and the Karlin–Altschul conversion in
``search.evalue``. Consumed by ``launch/search_run``.
"""
from .engine import SearchConfig, SearchEngine, seed_counts_batch
from .evalue import bit_scores, evalues
from .index import SearchIndex

__all__ = ["SearchConfig", "SearchEngine", "SearchIndex",
           "seed_counts_batch", "bit_scores", "evalues"]
