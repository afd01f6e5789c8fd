"""Labeled metrics: a thread-safe registry of counters, gauges and
log-bucketed histograms, with Prometheus text exposition.

The reference gets this for free from the ``tracing``/``metrics`` crate
ecosystem; this is the Python analogue sized for our needs:

* **Counter** — monotone, ``inc(n)``.
* **Gauge** — last-write-wins, ``set(v)`` / ``add(n)``.
* **Histogram** — log-bucketed (geometric grid, factor ``2**0.25`` ≈ 19%
  per bucket), exposing ``percentile(q)`` (p50/p95/p99 within one bucket
  width of the exact quantile) plus count/sum/min/max. Buckets are stored
  sparsely, so an instrument costs a handful of dict slots regardless of
  the value range.

Every instrument family supports labels (``registry.counter("sync.retry",
peer="a")``); distinct label sets per family are capped
(``max_label_sets``, default 128) — past the cap, new sets collapse into
a single ``{overflow="true"}`` child so a label drawn from an unbounded
domain can degrade the data but never the process.

All mutation happens under one registry ``RLock``; instruments are cheap
enough to sit on hot paths (one lock round-trip + a few dict ops).
"""

from __future__ import annotations

import math
import re
import threading
from typing import Dict, Iterable, List, Optional, Tuple

# geometric bucket grid: upper bound of bucket i is FACTOR**i. FACTOR =
# 2**0.25 puts ~19% relative width on every bucket — the error bound on
# percentile estimates. Indices clamp to ±_IDX_RANGE (≈1e-15..1e15 for
# seconds or bytes); <=0 observations take the dedicated zero bucket.
FACTOR = 2.0 ** 0.25
_LOG_FACTOR = math.log(FACTOR)
_IDX_RANGE = 200
_ZERO_IDX = -(_IDX_RANGE + 1)

_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_metric_name(name: str) -> str:
    """Dots (our namespace separator) and other invalid characters become
    underscores; a leading digit gets a leading underscore."""
    s = _NAME_SANITIZE.sub("_", name)
    if s and s[0].isdigit():
        s = "_" + s
    return s


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _unescape_label_value(v: str) -> str:
    out: List[str] = []
    i = 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            out.append({"n": "\n", '"': '"', "\\": "\\"}.get(nxt, "\\" + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _format_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{sanitize_metric_name(k)}="{_escape_label_value(v)}"'
        for k, v in labels
    )
    return "{" + inner + "}"


class _Instrument:
    __slots__ = ("family", "labels")

    def __init__(self, family: "_Family", labels: Tuple[Tuple[str, str], ...]):
        self.family = family
        self.labels = labels

    @property
    def _lock(self):
        return self.family.registry.lock


class Counter(_Instrument):
    __slots__ = ("value",)

    def __init__(self, family, labels):
        super().__init__(family, labels)
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._inc_locked(n)

    def _inc_locked(self, n: int = 1) -> None:
        self.value += n


class Gauge(_Instrument):
    __slots__ = ("value",)

    def __init__(self, family, labels):
        super().__init__(family, labels)
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = v

    def add(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Histogram(_Instrument):
    __slots__ = ("n", "total", "vmin", "vmax", "buckets")

    def __init__(self, family, labels):
        super().__init__(family, labels)
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.buckets: Dict[int, int] = {}

    def observe(self, v: float) -> None:
        with self._lock:
            self._observe_locked(v)

    def _observe_locked(self, v: float) -> None:
        self.n += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if v <= 0.0:
            i = _ZERO_IDX
        else:
            i = math.ceil(math.log(v) / _LOG_FACTOR)
            if i < -_IDX_RANGE:
                i = -_IDX_RANGE
            elif i > _IDX_RANGE:
                i = _IDX_RANGE
        b = self.buckets
        b[i] = b.get(i, 0) + 1

    @staticmethod
    def bucket_bounds(i: int) -> Tuple[float, float]:
        """(exclusive lower, inclusive upper) value bound of bucket ``i``."""
        if i == _ZERO_IDX:
            return (0.0, 0.0)
        lo = 0.0 if i == -_IDX_RANGE else FACTOR ** (i - 1)
        return (lo, FACTOR ** i)

    def percentile(self, q: float) -> float:
        """Quantile estimate by linear interpolation inside the bucket the
        rank lands in; exact min/max clamp the tails. 0.0 when empty."""
        with self._lock:
            if self.n == 0:
                return 0.0
            target = q * self.n
            cum = 0
            for i in sorted(self.buckets):
                c = self.buckets[i]
                if cum + c >= target:
                    lo, hi = self.bucket_bounds(i)
                    frac = (target - cum) / c
                    val = lo + (hi - lo) * frac
                    return min(max(val, self.vmin), self.vmax)
                cum += c
            return self.vmax

    def summary(self) -> dict:
        with self._lock:
            n, total = self.n, self.total
            vmin = self.vmin if n else 0.0
            vmax = self.vmax if n else 0.0
        return {
            "count": n,
            "sum": total,
            "min": vmin,
            "max": vmax,
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
        }

    def cumulative_buckets(self) -> List[Tuple[float, int]]:
        """[(le_bound, cumulative_count)] over the buckets actually hit —
        the sparse form Prometheus's cumulative ``_bucket`` series allows."""
        with self._lock:
            cum = 0
            out: List[Tuple[float, int]] = []
            for i in sorted(self.buckets):
                cum += self.buckets[i]
                out.append((self.bucket_bounds(i)[1], cum))
            return out


_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}
# the cardinality-cap catch-all child's label set
_OVERFLOW_LABELS = (("overflow", "true"),)


class _Family:
    """One metric name: a type, a help string, and children by label set."""

    __slots__ = ("registry", "name", "type", "help", "children")

    def __init__(self, registry, name: str, type_: str, help_: str = ""):
        self.registry = registry
        self.name = name
        self.type = type_
        self.help = help_
        self.children: Dict[Tuple[Tuple[str, str], ...], _Instrument] = {}

    def _child_locked(self, labels: Tuple[Tuple[str, str], ...]):
        child = self.children.get(labels)
        if child is None:
            if (
                labels
                and labels != _OVERFLOW_LABELS
                and len(self.children) >= self.registry.max_label_sets
            ):
                return self._child_locked(_OVERFLOW_LABELS)
            child = _TYPES[self.type](self, labels)
            self.children[labels] = child
        return child


class MetricsRegistry:
    """Thread-safe instrument store. One global instance lives in
    ``automerge_tpu_torch.obs``; tests construct their own."""

    def __init__(self, max_label_sets: int = 128):
        self.lock = threading.RLock()
        self.max_label_sets = max_label_sets
        # keyed by (name, type): a counter and a span histogram may share a
        # base name (e.g. device.delta_resolve counts calls AND times them);
        # the Prometheus rendering disambiguates (_total vs _bucket/_sum)
        self._families: Dict[Tuple[str, str], _Family] = {}

    # -- instrument lookup (get-or-create) ----------------------------------

    def _family_locked(self, name: str, type_: str, help_: str) -> _Family:
        fam = self._families.get((name, type_))
        if fam is None:
            fam = _Family(self, name, type_, help_)
            self._families[(name, type_)] = fam
        return fam

    def _get_locked(self, name, type_, labels: dict, help_=""):
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        return self._family_locked(name, type_, help_)._child_locked(key)

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        with self.lock:
            return self._get_locked(name, "counter", labels, help)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        with self.lock:
            return self._get_locked(name, "gauge", labels, help)

    def histogram(self, name: str, help: str = "", **labels) -> Histogram:
        with self.lock:
            return self._get_locked(name, "histogram", labels, help)

    def families(self) -> List[Tuple[str, str]]:
        """Sorted (name, type) pairs of every registered family."""
        with self.lock:
            return sorted(self._families)

    # -- removal (per-doc label hygiene) -------------------------------------

    def remove_labels(self, name: str, labels: dict,
                      type_: Optional[str] = None) -> int:
        """Remove the child with exactly this label set from every
        family named ``name`` (optionally one type). Returns how many
        children were removed.

        The reason this exists: per-document gauges
        (``doc.journal_bytes{doc=...}`` and friends) are keyed by an
        unbounded domain, and a long-lived server that opens documents
        forever would otherwise fill each family's cardinality cap with
        dead label sets — at which point every NEW document collapses
        into ``{overflow="true"}`` and the admission signal the tiered
        store's policy feeds on goes dark. Removing the labels when a
        document closes or demotes to cold keeps the cap's slots
        circulating among live documents. (Counters stay monotone for
        scrapers; removal is meant for gauges/histograms whose subject
        no longer exists — removing a counter's child is allowed but
        resets that series.)"""
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        removed = 0
        with self.lock:
            for (fname, ftype), fam in self._families.items():
                if fname != name or (type_ is not None and ftype != type_):
                    continue
                if fam.children.pop(key, None) is not None:
                    removed += 1
        return removed

    def gauge_remove(self, name: str, **labels) -> bool:
        """Remove one gauge child (sugar over ``remove_labels``)."""
        return self.remove_labels(name, labels, type_="gauge") > 0

    def reset(self) -> None:
        with self.lock:
            self._families.clear()

    # -- exposition ---------------------------------------------------------

    def render_prometheus(self) -> str:
        """Prometheus text format v0.0.4. Counter families render with the
        conventional ``_total`` suffix; histograms render sparse cumulative
        ``_bucket`` series plus ``_sum``/``_count``."""
        with self.lock:
            lines: List[str] = []
            for key in sorted(self._families):
                fam = self._families[key]
                pname = sanitize_metric_name(fam.name)
                if fam.type == "counter":
                    pname += "_total"
                if fam.help:
                    lines.append(f"# HELP {pname} {fam.help}")
                lines.append(f"# TYPE {pname} {fam.type}")
                for labels in sorted(fam.children):
                    child = fam.children[labels]
                    ltxt = _format_labels(labels)
                    if fam.type in ("counter", "gauge"):
                        lines.append(f"{pname}{ltxt} {_fmt_num(child.value)}")
                    else:
                        for le, cum in child.cumulative_buckets():
                            le_labels = labels + (("le", _fmt_num(le)),)
                            lines.append(
                                f"{pname}_bucket{_format_labels(le_labels)} {cum}"
                            )
                        inf_labels = labels + (("le", "+Inf"),)
                        lines.append(
                            f"{pname}_bucket{_format_labels(inf_labels)} {child.n}"
                        )
                        lines.append(f"{pname}_sum{ltxt} {_fmt_num(child.total)}")
                        lines.append(f"{pname}_count{ltxt} {child.n}")
            return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> List[dict]:
        """JSON-friendly dump: one entry per instrument child."""
        with self.lock:
            out: List[dict] = []
            for key in sorted(self._families):
                fam = self._families[key]
                for labels in sorted(fam.children):
                    child = fam.children[labels]
                    entry = {"name": fam.name, "type": fam.type,
                             "labels": dict(labels)}
                    if fam.type == "histogram":
                        entry.update(child.summary())
                    else:
                        entry["value"] = child.value
                    out.append(entry)
            return out


def _fmt_num(v) -> str:
    if isinstance(v, float):
        if v == math.inf:
            return "+Inf"
        if v == -math.inf:
            return "-Inf"
        if v != v:
            return "NaN"
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(v)
    return str(v)


# -- parsing (round-trip validation + scrape-side tooling) -------------------

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?\s+(\S+)$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _parse_label_text(ltxt: Optional[str]) -> List[Tuple[str, str]]:
    """``{k="v",...}`` (or None) -> [(k, v)] with escapes undone."""
    labels: List[Tuple[str, str]] = []
    if ltxt:
        body = ltxt[1:-1]
        pos = 0
        while pos < len(body):
            lm = _LABEL_RE.match(body, pos)
            if lm is None:
                raise ValueError(f"unparseable labels: {ltxt!r}")
            labels.append((lm.group(1), _unescape_label_value(lm.group(2))))
            pos = lm.end()
            if pos < len(body) and body[pos] == ",":
                pos += 1
    return labels


def parse_prometheus(text: str) -> Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float]:
    """Parse Prometheus text exposition back into
    ``{(name, sorted_label_items): value}`` — the round-trip half used by
    tests and by clients scraping the RPC ``metrics`` method."""
    out: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"unparseable sample line: {line!r}")
        name, ltxt, vtxt = m.groups()
        labels = _parse_label_text(ltxt)
        value = math.inf if vtxt == "+Inf" else float(vtxt)
        out[(name, tuple(sorted(labels)))] = value
    return out


def merge_prometheus(bodies: Dict[str, str], label: str = "node") -> str:
    """Merge per-node Prometheus expositions into ONE family set.

    ``bodies`` maps a node name to that node's ``render_prometheus()``
    text. Every sample gains a ``node="<name>"`` label (hostile node
    names are escaped exactly like any label value; a pre-existing label
    of the same name is replaced — the scraper's identity wins), family
    ``# TYPE``/``# HELP`` lines are unioned (first declaration wins),
    and histogram ``_bucket``/``_sum``/``_count`` series stay grouped
    under their family. Sample values pass through verbatim, so the
    merge is lossless and re-parses with ``parse_prometheus``."""
    types: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    samples: Dict[str, List[str]] = {}
    for node in sorted(bodies):
        for line in bodies[node].splitlines():
            line = line.strip()
            if not line:
                continue
            if line.startswith("# TYPE ") or line.startswith("# HELP "):
                parts = line.split(None, 3)
                if len(parts) >= 4:
                    target = types if parts[1] == "TYPE" else helps
                    target.setdefault(parts[2], parts[3])
                continue
            if line.startswith("#"):
                continue
            m = _SAMPLE_RE.match(line)
            if m is None:
                raise ValueError(f"unparseable sample line: {line!r}")
            name, ltxt, vtxt = m.groups()
            labels = [
                (k, v) for k, v in _parse_label_text(ltxt) if k != label
            ] + [(label, str(node))]
            ltxt_out = _format_labels(tuple(sorted(labels)))
            samples.setdefault(name, []).append(f"{name}{ltxt_out} {vtxt}")

    lines: List[str] = []
    emitted = set()
    for fam in sorted(types):
        if fam in helps:
            lines.append(f"# HELP {fam} {helps[fam]}")
        lines.append(f"# TYPE {fam} {types[fam]}")
        # counters/gauges sample under the family name itself; histogram
        # families fan out into the three conventional series
        for sname in (fam, fam + "_bucket", fam + "_sum", fam + "_count"):
            for s in samples.get(sname, ()):
                lines.append(s)
            emitted.add(sname)
    # samples whose body carried no TYPE line still merge (sorted tail)
    for sname in sorted(samples):
        if sname not in emitted:
            lines.extend(samples[sname])
    return "\n".join(lines) + ("\n" if lines else "")
