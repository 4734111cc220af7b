"""repro_torch.serve — the MSA web service and its store on PyTorch.

HAlign-II's third contribution is "a user-friendly web server based on
our distributed computing infrastructure"; this package is that layer
over the port's engines, module for module the reference's
``repro.serve``:

  ``cache``        content-hash result cache over canonicalized sequence
                   sets (LRU + byte budget, hit/miss stats)
  ``queue``        deadline-aware coalescing: concurrent align requests
                   merge into ``AlignEngine.align_pairs``'s pow2 buckets
                   so one kernel call serves many callers
  ``incremental``  add-to-MSA against a frozen center + merged gap
                   pattern — bit-identical columns for already-aligned
                   members, full realign past a drift threshold
  ``store``        persistent generation-versioned MSAStore of *named*
                   alignments: atomic crash-safe commits, retention,
                   corrupt-latest fallback, background drift realign
                   with atomic swap (``--store-dir``); the reference's
                   on-disk schema
  ``service``      the MSAService facade + stdlib HTTP/JSON front end
                   (``/align``, ``/align/add``, ``/tree``, ``/search``,
                   ``/healthz``, ``/metrics``, ``/statusz``), on the card
                   by default, with a job loop for the other ranks of a
                   mesh

``repro_torch.launch.serve_msa`` is the CLI entry point.
"""
from .cache import ResultCache, canonical_key, canonicalize  # noqa: F401
from .incremental import AddResult, add_to_msa  # noqa: F401
from .queue import AlignJob, CoalescingAligner  # noqa: F401
from .service import MSAService, ServiceConfig, serve_http  # noqa: F401
from .store import (MSAStore, StoreEntry, StoreError,  # noqa: F401
                    content_fingerprint)
