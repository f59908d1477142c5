"""Metrics registry: Counter/Gauge/Histogram with labels (ROADMAP 5c).

Prometheus-flavoured primitives on the *virtual* serving stack: counters
and histograms are updated inline by the instrumented subsystems (behind
the ``obs is not None`` guard, so the hot path pays nothing when
telemetry is off); gauges for derived state — pool occupancy, tier
usage, queue ETAs — are refreshed lazily by *collect callbacks* at
exposition/snapshot time, so per-step cost stays zero.

Exposition is deterministic: metrics sort by name, children by label
values, and numbers format identically across runs — the CI telemetry
job diffs same-seed snapshots byte-for-byte.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional


def _fmt(v: float) -> str:
    """Prometheus sample value: integers without a trailing .0 (stable
    across int/float feeding), everything else via repr (round-trip
    exact, deterministic)."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape(v: str) -> str:
    """Label-value escaping per the exposition format: backslash, double
    quote and newline (in that order — backslash first so the escapes it
    introduces are not re-escaped)."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    """HELP-line escaping: only backslash and newline (quotes are legal
    verbatim on HELP lines, unlike inside label values)."""
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _unescape(s: str) -> str:
    """Inverse of :func:`_escape` / :func:`_escape_help`."""
    out, i, n = [], 0, len(s)
    while i < n:
        c = s[i]
        if c == "\\" and i + 1 < n:
            nxt = s[i + 1]
            if nxt == "\\":
                out.append("\\")
                i += 2
                continue
            if nxt == '"':
                out.append('"')
                i += 2
                continue
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
        out.append(c)
        i += 1
    return "".join(out)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: tuple = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)

    def _label_str(self, key: tuple, extra: str = "") -> str:
        pairs = [f'{n}="{_escape(v)}"' for n, v in zip(self.labelnames, key)]
        if extra:
            pairs.append(extra)
        return "{" + ",".join(pairs) + "}" if pairs else ""


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help: str, labelnames: tuple = ()):
        super().__init__(name, help, labelnames)
        self.values: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, labels: tuple = ()) -> None:
        # hot path: `labels` must be a tuple of strings matching
        # labelnames — used directly as the dict key, no normalization
        v = self.values
        v[labels] = v.get(labels, 0.0) + amount

    def expose(self) -> list[str]:
        return [f"{self.name}{self._label_str(k)} {_fmt(v)}"
                for k, v in sorted(self.values.items())]

    def snap(self) -> list[dict]:
        return [{"labels": dict(zip(self.labelnames, k)), "value": v}
                for k, v in sorted(self.values.items())]


class Gauge(Counter):
    kind = "gauge"

    def __init__(self, name: str, help: str, labelnames: tuple = (),
                 summable: bool = True):
        super().__init__(name, help, labelnames)
        # quantiles, ratios and other order statistics cannot be summed
        # across replicas: summable=False keeps them out of any
        # label-dropping aggregation (fleet view) instead of exposing a
        # silently-wrong sum
        self.summable = summable

    def set(self, value: float, labels: tuple = ()) -> None:
        self.values[labels] = float(value)


class Histogram(_Metric):
    kind = "histogram"
    DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                       0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                       120.0, 300.0, 600.0, 1800.0)

    def __init__(self, name: str, help: str, labelnames: tuple = (),
                 buckets: Optional[Iterable[float]] = None):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(buckets or self.DEFAULT_BUCKETS))
        # label key -> [bucket counts..., +Inf count], sum
        self.counts: dict[tuple, list] = {}
        self.sums: dict[tuple, float] = {}

    def observe(self, value: float, labels: tuple = ()) -> None:
        key = labels
        counts = self.counts.get(key)
        if counts is None:
            counts = self.counts[key] = [0] * (len(self.buckets) + 1)
            self.sums[key] = 0.0
        v = float(value)
        for i, le in enumerate(self.buckets):
            if v <= le:
                counts[i] += 1
                break
        else:
            counts[-1] += 1
        self.sums[key] += v

    def _cumulative(self, key: tuple) -> list[int]:
        out, acc = [], 0
        for c in self.counts[key]:
            acc += c
            out.append(acc)
        return out

    def expose(self) -> list[str]:
        lines = []
        for key in sorted(self.counts):
            cum = self._cumulative(key)
            for le, c in zip(self.buckets, cum):
                extra = 'le="%s"' % _fmt(le)
                lines.append(f"{self.name}_bucket"
                             f"{self._label_str(key, extra)} {c}")
            inf = 'le="+Inf"'
            lines.append(f"{self.name}_bucket"
                         f"{self._label_str(key, inf)} {cum[-1]}")
            lines.append(f"{self.name}_sum{self._label_str(key)} "
                         f"{_fmt(self.sums[key])}")
            lines.append(f"{self.name}_count{self._label_str(key)} {cum[-1]}")
        return lines

    def snap(self) -> list[dict]:
        out = []
        for key in sorted(self.counts):
            cum = self._cumulative(key)
            out.append({"labels": dict(zip(self.labelnames, key)),
                        "buckets": {_fmt(le): c for le, c
                                    in zip(self.buckets, cum)},
                        "count": cum[-1], "sum": self.sums[key]})
        return out


class MetricsRegistry:
    """Named metric store + lazy collectors + exposition/snapshot."""

    def __init__(self):
        self.metrics: dict[str, _Metric] = {}
        self._collectors: list[Callable[[], None]] = []

    def _get(self, cls, name: str, help: str, labelnames: tuple,
             **kw) -> _Metric:
        m = self.metrics.get(name)
        if m is not None:
            assert isinstance(m, cls), (name, m.kind)
            return m
        m = cls(name, help, labelnames, **kw)
        self.metrics[name] = m
        return m

    def counter(self, name: str, help: str, labelnames: tuple = ()) -> Counter:
        return self._get(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str, labelnames: tuple = (),
              summable: bool = True) -> Gauge:
        return self._get(Gauge, name, help, labelnames, summable=summable)

    def histogram(self, name: str, help: str, labelnames: tuple = (),
                  buckets: Optional[Iterable[float]] = None) -> Histogram:
        return self._get(Histogram, name, help, labelnames, buckets=buckets)

    def on_collect(self, fn: Callable[[], None]) -> None:
        """Register a gauge-refresh callback, run before every
        exposition/snapshot (never on the step hot path)."""
        self._collectors.append(fn)

    def collect(self) -> None:
        for fn in self._collectors:
            fn()

    def exposition(self) -> str:
        """Prometheus text format (deterministic ordering)."""
        self.collect()
        lines = []
        for name in sorted(self.metrics):
            m = self.metrics[name]
            lines.append(f"# HELP {name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {name} {m.kind}")
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-able snapshot mirroring the exposition."""
        self.collect()
        return {name: {"type": m.kind, "help": m.help,
                       "labels": list(m.labelnames), "values": m.snap()}
                for name, m in sorted(self.metrics.items())}


# --------------------------------------------------------------- parsing
def _parse_sample(line: str) -> tuple[str, dict, float]:
    """One sample line -> (name, labels, value). Label values are scanned
    character-wise so escaped quotes/backslashes/newlines round-trip."""
    brace = line.find("{")
    if brace == -1:
        name, _, val = line.partition(" ")
        return name, {}, float(val)
    name = line[:brace]
    labels: dict[str, str] = {}
    i = brace + 1
    while line[i] != "}":
        eq = line.index("=", i)
        lname = line[i:eq]
        assert line[eq + 1] == '"', line
        j = eq + 2
        buf = []
        while line[j] != '"':
            if line[j] == "\\" and j + 1 < len(line):
                buf.append({"\\": "\\", '"': '"', "n": "\n"}.get(
                    line[j + 1], line[j + 1]))
                j += 2
            else:
                buf.append(line[j])
                j += 1
        labels[lname] = "".join(buf)
        i = j + 1
        if line[i] == ",":
            i += 1
    val = line[i + 1:].strip()
    return name, labels, float(val)


def parse_exposition(text: str) -> dict:
    """Parse Prometheus text exposition back into metric families:
    ``{family: {"type": ..., "help": ..., "samples": [{"name", "labels",
    "value"}, ...]}}``. Histogram ``_bucket`` / ``_sum`` / ``_count``
    samples attach to their family. The CI ``http-smoke`` job and the
    round-trip test both consume this — it must accept exactly what
    :meth:`MetricsRegistry.exposition` emits."""
    fams: dict[str, dict] = {}
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            name, _, help_ = line[len("# HELP "):].partition(" ")
            fams.setdefault(name, {"samples": []})["help"] = _unescape(help_)
        elif line.startswith("# TYPE "):
            name, _, kind = line[len("# TYPE "):].partition(" ")
            fams.setdefault(name, {"samples": []})["type"] = kind.strip()
        elif line.startswith("#"):
            continue
        else:
            name, labels, value = _parse_sample(line)
            fam = name
            if fam not in fams:
                for suffix in ("_bucket", "_sum", "_count"):
                    if name.endswith(suffix) and name[:-len(suffix)] in fams:
                        fam = name[:-len(suffix)]
                        break
            fams.setdefault(fam, {"samples": []})["samples"].append(
                {"name": name, "labels": labels, "value": value})
    return fams


# ----------------------------------------------------------- aggregation
def _drop_key(key: tuple, idx: Optional[int]) -> tuple:
    if idx is None:
        return key
    return key[:idx] + key[idx + 1:]


def aggregate(registry: MetricsRegistry,
              drop_label: str = "replica") -> MetricsRegistry:
    """Fleet view: a new registry with ``drop_label`` removed from every
    metric and same-key children summed across it (counters and histogram
    buckets add; gauges report fleet totals — occupancy-style gauges sum
    meaningfully, ETAs read as aggregate backlog). Gauges declared
    ``summable=False`` (quantiles, error percentiles) that carry the
    dropped label are *omitted entirely* — a fleet view must never
    expose a silently-wrong summed quantile; scrape the per-replica
    view for those. Deterministic: child ordering is re-derived from
    the merged keys at exposition time."""
    registry.collect()
    out = MetricsRegistry()
    for name, m in registry.metrics.items():
        if drop_label in m.labelnames:
            idx = m.labelnames.index(drop_label)
            names = tuple(n for n in m.labelnames if n != drop_label)
        else:
            idx, names = None, m.labelnames
        if isinstance(m, Histogram):
            h = out.histogram(name, m.help, names, buckets=m.buckets)
            for key, counts in m.counts.items():
                k = _drop_key(key, idx)
                cur = h.counts.get(k)
                if cur is None:
                    h.counts[k] = list(counts)
                    h.sums[k] = m.sums[key]
                else:
                    for i, c in enumerate(counts):
                        cur[i] += c
                    h.sums[k] += m.sums[key]
        elif isinstance(m, Gauge):
            if not m.summable and idx is not None:
                continue          # explicitly absent from the fleet view
            agg = out.gauge(name, m.help, names, summable=m.summable)
            for key, v in m.values.items():
                k = _drop_key(key, idx)
                agg.values[k] = agg.values.get(k, 0.0) + v
        else:
            agg = out.counter(name, m.help, names)
            for key, v in m.values.items():
                k = _drop_key(key, idx)
                agg.values[k] = agg.values.get(k, 0.0) + v
    return out
