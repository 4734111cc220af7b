"""repro_torch.align — the backend-dispatching engine for the map(1) stage.

See ``engine.AlignEngine`` (host API: bucketing + fallback), ``backends``
(the Gotoh DP + traceback primitive, kernel on the card, plain on the
CPU) and ``bucketing`` (power-of-two length buckets).
"""
from .backends import BatchAlignment, resolve_backend  # noqa: F401
from .engine import AlignEngine, EngineResult, PairsResult  # noqa: F401
