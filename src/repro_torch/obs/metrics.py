"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

Dependency-free (stdlib only — importing this module must never pull in
torch).  One global ``REGISTRY`` holds labeled *families*; a family plus a
concrete label assignment is a *child* that carries the actual value:

    REQS = metrics.counter("repro_requests_started_total",
                           "requests accepted", ("endpoint",))
    REQS.labels(endpoint="align").inc()

``snapshot()`` returns a plain-dict view (embedded in BENCH_* artifacts
and ``--metrics-out`` files); ``render()`` emits Prometheus text
exposition (served by ``GET /metrics``); ``parse_exposition()`` is the
inverse used by the CI service-smoke step to gate on schema drift.

The registry-wide ``enabled`` flag turns every write into a no-op — the
overhead-guardrail benchmarks flip it to measure instrumented vs bare
runs on identical code paths.
"""
from __future__ import annotations

import bisect
import json
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "Family", "MetricsRegistry",
    "REGISTRY", "counter", "gauge", "histogram", "parse_exposition",
    "DEFAULT_BUCKETS",
]

# Latency buckets in seconds: 1 ms .. 30 s, roughly 1-2.5-5 per decade.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0,
)


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _fmt_labels(labels: Dict[str, str], extra: str = "") -> str:
    parts = [f'{k}="{_escape_label(str(v))}"' for k, v in labels.items()]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Child:
    __slots__ = ("_family", "labels")

    def __init__(self, family: "Family", labels: Dict[str, str]):
        self._family = family
        self.labels = labels

    @property
    def _lock(self) -> threading.Lock:
        return self._family.registry._lock

    @property
    def _enabled(self) -> bool:
        return self._family.registry.enabled


class Counter(_Child):
    __slots__ = ("value",)

    def __init__(self, family, labels):
        super().__init__(family, labels)
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if not self._enabled:
            return
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += amount


class Gauge(_Child):
    __slots__ = ("value",)

    def __init__(self, family, labels):
        super().__init__(family, labels)
        self.value = 0.0

    def set(self, value: float) -> None:
        if not self._enabled:
            return
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        if not self._enabled:
            return
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class Histogram(_Child):
    __slots__ = ("bucket_counts", "sum", "count")

    def __init__(self, family, labels):
        super().__init__(family, labels)
        self.bucket_counts = [0] * (len(family.buckets) + 1)  # + overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        if not self._enabled:
            return
        i = bisect.bisect_left(self._family.buckets, value)
        with self._lock:
            self.bucket_counts[i] += 1
            self.sum += value
            self.count += 1


_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Family:
    """A named metric with a fixed label schema; children carry values."""

    def __init__(self, registry: "MetricsRegistry", name: str, mtype: str,
                 help: str, labelnames: Sequence[str],
                 buckets: Optional[Sequence[float]] = None):
        self.registry = registry
        self.name = name
        self.type = mtype
        self.help = help
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(sorted(buckets)) if mtype == "histogram" else ()
        self._children: Dict[Tuple[str, ...], _Child] = {}

    def labels(self, **kv: str) -> _Child:
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(kv)} != schema "
                f"{sorted(self.labelnames)}")
        key = tuple(str(kv[k]) for k in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self.registry._lock:
                child = self._children.get(key)
                if child is None:
                    child = _TYPES[self.type](
                        self, dict(zip(self.labelnames, key)))
                    self._children[key] = child
        return child

    # Convenience: unlabeled families proxy straight to their one child.
    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def set(self, value: float) -> None:
        self.labels().set(value)

    def dec(self, amount: float = 1.0) -> None:
        self.labels().dec(amount)

    def observe(self, value: float) -> None:
        self.labels().observe(value)

    @property
    def value(self) -> float:
        return self.labels().value

    def children(self) -> List[_Child]:
        with self.registry._lock:
            return list(self._children.values())


class MetricsRegistry:
    """Thread-safe get-or-create store of metric families."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, Family] = {}
        self.enabled = True

    def _get_or_create(self, name: str, mtype: str, help: str,
                       labelnames: Sequence[str],
                       buckets: Optional[Sequence[float]] = None) -> Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.type != mtype:
                    raise ValueError(
                        f"metric {name} already registered as {fam.type}, "
                        f"not {mtype}")
                if fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name} already registered with labels "
                        f"{fam.labelnames}, not {tuple(labelnames)}")
                return fam
            fam = Family(self, name, mtype, help, labelnames, buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Family:
        return self._get_or_create(name, "counter", help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Family:
        return self._get_or_create(name, "gauge", help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Family:
        return self._get_or_create(name, "histogram", help, labelnames,
                                   buckets)

    def families(self) -> List[Family]:
        with self._lock:
            return list(self._families.values())

    def reset(self) -> None:
        """Drop every family (tests only — holders keep stale handles)."""
        with self._lock:
            self._families.clear()

    # ------------------------------------------------------------- export

    def snapshot(self) -> Dict[str, dict]:
        """Plain-dict view of every family, for JSON embedding."""
        out: Dict[str, dict] = {}
        for fam in self.families():
            samples = []
            for child in fam.children():
                with self._lock:
                    if fam.type == "histogram":
                        samples.append({
                            "labels": dict(child.labels),
                            "count": child.count,
                            "sum": child.sum,
                            "buckets": {
                                _fmt_value(le): int(sum(
                                    child.bucket_counts[:i + 1]))
                                for i, le in enumerate(fam.buckets)
                            },
                        })
                    else:
                        samples.append({"labels": dict(child.labels),
                                        "value": child.value})
            out[fam.name] = {"type": fam.type, "help": fam.help,
                             "samples": samples}
        return out

    def render(self) -> str:
        """Prometheus text exposition (format version 0.0.4)."""
        lines: List[str] = []
        for fam in sorted(self.families(), key=lambda f: f.name):
            lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.type}")
            for child in fam.children():
                with self._lock:
                    if fam.type == "histogram":
                        cum = 0
                        for i, le in enumerate(fam.buckets):
                            cum += child.bucket_counts[i]
                            extra = 'le="%s"' % _fmt_value(le)
                            lines.append(
                                f"{fam.name}_bucket"
                                f"{_fmt_labels(child.labels, extra)}"
                                f" {cum}")
                        inf_extra = 'le="+Inf"'
                        lines.append(
                            f"{fam.name}_bucket"
                            f"{_fmt_labels(child.labels, inf_extra)}"
                            f" {child.count}")
                        lines.append(
                            f"{fam.name}_sum{_fmt_labels(child.labels)}"
                            f" {_fmt_value(child.sum)}")
                        lines.append(
                            f"{fam.name}_count{_fmt_labels(child.labels)}"
                            f" {child.count}")
                    else:
                        lines.append(
                            f"{fam.name}{_fmt_labels(child.labels)}"
                            f" {_fmt_value(child.value)}")
        return "\n".join(lines) + "\n"

    def write_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)


REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "",
            labelnames: Sequence[str] = ()) -> Family:
    return REGISTRY.counter(name, help, labelnames)


def gauge(name: str, help: str = "", labelnames: Sequence[str] = ()) -> Family:
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name: str, help: str = "", labelnames: Sequence[str] = (),
              buckets: Sequence[float] = DEFAULT_BUCKETS) -> Family:
    return REGISTRY.histogram(name, help, labelnames, buckets)


def parse_exposition(text: str) -> Dict[str, dict]:
    """Parse Prometheus text back to ``{family: {type, samples}}``.

    Histogram series (``_bucket``/``_sum``/``_count``) are folded into
    their parent family.  Raises ``ValueError`` on malformed lines, which
    is exactly what the CI schema gate wants.
    """
    families: Dict[str, dict] = {}
    types: Dict[str, str] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                types[parts[2]] = parts[3] if len(parts) > 3 else ""
                families.setdefault(parts[2], {"type": parts[3],
                                               "samples": []})
            continue
        brace = line.find("{")
        if brace >= 0:
            close = line.rfind("}")
            if close < brace:
                raise ValueError(f"line {lineno}: unbalanced braces: {line}")
            name = line[:brace]
            labelstr = line[brace + 1:close]
            rest = line[close + 1:].strip()
            labels: Dict[str, str] = {}
            for item in _split_labels(labelstr):
                if "=" not in item:
                    raise ValueError(f"line {lineno}: bad label {item!r}")
                k, v = item.split("=", 1)
                if not (v.startswith('"') and v.endswith('"')):
                    raise ValueError(f"line {lineno}: unquoted label {item!r}")
                labels[k.strip()] = v[1:-1]
        else:
            name, _, rest = line.partition(" ")
            labels = {}
        rest = rest.strip()
        if not rest:
            raise ValueError(f"line {lineno}: missing value: {line}")
        value = float(rest.replace("+Inf", "inf"))
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            root = name[:-len(suffix)] if name.endswith(suffix) else None
            if root is not None and types.get(root) == "histogram":
                base = root
                break
        fam = families.setdefault(base, {"type": types.get(base, "untyped"),
                                         "samples": []})
        fam["samples"].append({"series": name, "labels": labels,
                               "value": value})
    return families


def _split_labels(s: str) -> Iterable[str]:
    out, cur, in_q, esc = [], [], False, False
    for ch in s:
        if esc:
            cur.append(ch)
            esc = False
        elif ch == "\\":
            cur.append(ch)
            esc = True
        elif ch == '"':
            cur.append(ch)
            in_q = not in_q
        elif ch == "," and not in_q:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return [x for x in (i.strip() for i in out) if x]
