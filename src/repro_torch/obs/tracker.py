"""Tracker: the observability interface every layer reports through.

The port's own copy of the reference's ``repro/obs/tracker.py`` (which
imports only numpy): the same classes, the same record semantics and the
same JSONL schema version, so each package reads the other's files.

One small levanter-style surface — ``log`` scalars/dicts against a
monotonically increasing step, ``count``/``gauge``/``histogram``
primitives, structured ``event`` records, and a ``time_block(name)``
context manager for wall-clock spans — with four backends:

* :class:`NoopTracker` — the default everywhere.  Every method is a bare
  ``pass`` and ``time_block`` returns a shared null context manager, so an
  uninstrumented-by-choice hot loop pays one attribute lookup + call per
  record site and **never** touches ``perf_counter`` (the span is never
  measured).  The serving engine additionally gates its per-step
  aggregation behind an ``is_noop`` check, so the default decode path does
  no metric bookkeeping at all.
* :class:`InMemoryTracker` — accumulates counters / last-value gauges /
  histogram observations / events in host dicts; the capture backend for
  tests, examples, and benchmark summaries (:meth:`InMemoryTracker.quantile`
  matches ``numpy.quantile`` exactly).
* :class:`JsonlTracker` — append-only line-delimited JSON with a stable
  schema (see :data:`SCHEMA_VERSION` and :func:`read_jsonl`); the artifact
  backend.
* :class:`CompositeTracker` — fans every record out to child trackers
  (e.g. capture in memory AND persist to jsonl in one run).

**Semantics.**  Counters are monotone: ``count`` rejects negative
increments, totals only grow.  Gauges are last-write-wins point-in-time
values.  Histograms record raw observations (no binning — backends keep
the values, quantiles are computed exactly on read).  Events are named
dict payloads for structured occurrences (admissions, preemptions,
bench rows) that don't reduce to one scalar.

**Steps.**  Every record carries an optional ``step``.  Steps must be
monotonically non-decreasing per tracker (a regression raises — mixing
two step domains through one tracker is a bug, not a rendering problem);
``step=None`` reuses the last step seen, so producers without their own
clock (e.g. the KV-cache allocator) inherit the engine's.

All backends record from already-host-resident Python values — no method
here ever forces a device sync; instrumented layers must only hand over
numbers they already had on the host.
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, IO, List, Mapping, Optional, Sequence, Union

import numpy as np

#: jsonl schema version; bump on any incompatible record-shape change
SCHEMA_VERSION = 1

#: the record kinds a backend may emit (the jsonl schema's closed set)
KINDS = ("count", "gauge", "histogram", "scalars", "event", "span")

Scalar = Union[int, float]


class _NullSpan:
    """Shared do-nothing context manager for :class:`NoopTracker` spans:
    no clock read, no allocation per use."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()

#: public alias: hot paths that gate on ``tracker.is_noop`` can use this to
#: skip even the ``time_block`` call itself (zero tracker calls per step)
NULL_SPAN = _NULL_SPAN


class _Span:
    """Wall-clock span: measures ``perf_counter`` across the ``with`` body
    and records the elapsed seconds as a histogram observation under
    ``name``.  Spans measure *host* wall-clock — for asynchronous CUDA
    launches that is launch time unless the span ends in a transfer or a
    synchronisation."""
    __slots__ = ("_tracker", "_name", "_step", "_t0", "seconds")

    def __init__(self, tracker: "Tracker", name: str, step: Optional[int]):
        self._tracker = tracker
        self._name = name
        self._step = step
        self.seconds: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        self._tracker.histogram(self._name, self.seconds, step=self._step)
        return False


class Tracker:
    """Base tracker: step bookkeeping + the record surface.

    Subclasses implement :meth:`_record`; the primitives normalize
    arguments, enforce step monotonicity and counter monotonicity, then
    hand one ``(kind, name, value, data, step)`` record down."""

    #: backends that provably discard everything set this; hot paths may
    #: skip metric *computation* (not just emission) when it is True
    is_noop = False

    def __init__(self) -> None:
        self._last_step = 0

    # -- step domain -------------------------------------------------------
    def _step_of(self, step: Optional[int]) -> int:
        if step is None:
            return self._last_step
        step = int(step)
        if step < self._last_step:
            raise ValueError(
                f"tracker step went backwards: {step} < {self._last_step} "
                f"(steps are monotone per tracker; use separate trackers "
                f"for separate step domains)")
        self._last_step = step
        return step

    # -- primitives --------------------------------------------------------
    def count(self, name: str, value: Scalar = 1, *,
              step: Optional[int] = None) -> None:
        """Increment the monotone counter ``name`` (negative increments
        raise — a counter that can decrease is a gauge)."""
        value = float(value)
        if value < 0:
            raise ValueError(
                f"counter {name!r} increment must be >= 0, got {value} "
                f"(counters are monotone; use gauge() for signed values)")
        self._record("count", name, value, None, self._step_of(step))

    def gauge(self, name: str, value: Scalar, *,
              step: Optional[int] = None) -> None:
        """Set the point-in-time value of ``name`` (last write wins)."""
        self._record("gauge", name, float(value), None, self._step_of(step))

    def histogram(self, name: str, value: Scalar, *,
                  step: Optional[int] = None) -> None:
        """Record one observation of ``name`` (raw value; quantiles are
        computed exactly on read, no binning)."""
        self._record("histogram", name, float(value), None,
                     self._step_of(step))

    def log(self, metrics: Mapping[str, Scalar], *,
            step: Optional[int] = None) -> None:
        """Log a dict of named scalars against ``step`` (the levanter-shaped
        entry point: one training/serving step's metrics in one call)."""
        data = {str(k): float(v) for k, v in metrics.items()}
        self._record("scalars", None, None, data, self._step_of(step))

    def event(self, name: str, data: Mapping[str, Any], *,
              step: Optional[int] = None) -> None:
        """Record a structured occurrence (admission, preemption, bench
        row): a named dict payload of json-serializable values."""
        self._record("event", name, None, dict(data), self._step_of(step))

    def time_block(self, name: str, *, step: Optional[int] = None):
        """Context manager measuring the wall-clock seconds of its body as
        a histogram observation under ``name``."""
        return _Span(self, name, step)

    def finish(self) -> None:
        """Flush/close the backend (idempotent; no-op by default)."""

    # -- backend -----------------------------------------------------------
    def _record(self, kind: str, name: Optional[str],
                value: Optional[float], data: Optional[Dict[str, Any]],
                step: int) -> None:
        raise NotImplementedError


class NoopTracker(Tracker):
    """Discards everything.  The default tracker of every instrumented
    layer: record sites cost one call, spans never read the clock."""

    is_noop = True

    def count(self, name, value=1, *, step=None):
        pass

    def gauge(self, name, value, *, step=None):
        pass

    def histogram(self, name, value, *, step=None):
        pass

    def log(self, metrics, *, step=None):
        pass

    def event(self, name, data, *, step=None):
        pass

    def time_block(self, name, *, step=None):
        return _NULL_SPAN

    def _record(self, kind, name, value, data, step):  # pragma: no cover
        pass


#: shared default instance — layers that were never handed a tracker all
#: point here, so ``tracker is NOOP`` is a valid fast-path check
NOOP = NoopTracker()


class InMemoryTracker(Tracker):
    """Accumulating host-side backend (tests / examples / summaries).

    ``counters``: name -> running total.  ``gauges``: name -> last value.
    ``histograms``: name -> list of raw observations.  ``events``: list of
    ``{"step", "name", **payload}`` dicts in record order — payload keys
    shadow the record's ``step``/``name`` (the engine uses this to keep
    per-run steps on admission events), so don't put a ``name`` in a
    payload you want to find via :meth:`events_named`.  ``scalars``:
    name -> list of ``(step, value)`` rows from :meth:`Tracker.log`.
    """

    def __init__(self) -> None:
        super().__init__()
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, List[float]] = {}
        self.events: List[Dict[str, Any]] = []
        self.scalars: Dict[str, List] = {}

    def _record(self, kind, name, value, data, step):
        if kind == "count":
            self.counters[name] = self.counters.get(name, 0.0) + value
        elif kind == "gauge":
            self.gauges[name] = value
        elif kind == "histogram":
            self.histograms.setdefault(name, []).append(value)
        elif kind == "scalars":
            for k, v in data.items():
                self.scalars.setdefault(k, []).append((step, v))
        elif kind == "event":
            self.events.append({"step": step, "name": name, **data})

    # -- read side ---------------------------------------------------------
    def counter(self, name: str) -> float:
        return self.counters.get(name, 0.0)

    def values(self, name: str) -> List[float]:
        return list(self.histograms.get(name, []))

    def quantile(self, name: str, q) -> float:
        """Exact quantile(s) of histogram ``name`` (``numpy.quantile`` on
        the raw observations — no binning error)."""
        vals = self.histograms.get(name)
        if not vals:
            raise KeyError(f"no observations recorded under {name!r}")
        return np.quantile(np.asarray(vals, np.float64), q)

    def events_named(self, name: str) -> List[Dict[str, Any]]:
        return [e for e in self.events if e["name"] == name]

    def counters_under(self, prefix: str) -> Dict[str, float]:
        """Counters whose name starts with ``prefix`` (e.g. per-adapter
        token totals under ``"engine/tokens/"``), prefix stripped."""
        return {k[len(prefix):]: v for k, v in self.counters.items()
                if k.startswith(prefix)}


class JsonlTracker(Tracker):
    """Append-only line-delimited JSON backend (the run's artifact).

    One record per line, stable schema (``v`` = :data:`SCHEMA_VERSION`)::

        {"v": 1, "t": <unix s>, "step": <int>, "kind": "count",
         "name": "engine/tokens/base", "value": 3.0}
        {"v": 1, "t": ..., "step": ..., "kind": "scalars",
         "data": {"train/loss": 2.1}}
        {"v": 1, "t": ..., "step": ..., "kind": "event",
         "name": "engine/admission", "data": {...}}

    ``count``/``gauge``/``histogram`` carry ``name`` + ``value``;
    ``scalars`` carries ``data``; ``event`` carries ``name`` + ``data``.
    Lines are written eagerly (line-buffered semantics) so a crashed run
    still leaves a readable prefix; :func:`read_jsonl` is the validated
    read side.
    """

    def __init__(self, path: str) -> None:
        super().__init__()
        self.path = path
        self._f: Optional[IO[str]] = open(path, "a")

    def _record(self, kind, name, value, data, step):
        if self._f is None:
            raise ValueError(f"JsonlTracker({self.path!r}) already finished")
        rec: Dict[str, Any] = {"v": SCHEMA_VERSION, "t": round(time.time(), 3),
                               "step": step, "kind": kind}
        if name is not None:
            rec["name"] = name
        if value is not None:
            rec["value"] = value
        if data is not None:
            rec["data"] = data
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def finish(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()
        return False


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Read + validate a :class:`JsonlTracker` file; returns the records.

    Every line must parse, carry the current :data:`SCHEMA_VERSION`, a
    known ``kind``, and the fields that kind requires — a partial trailing
    line (crashed writer) raises, so artifact consumers fail loudly rather
    than aggregating a silently-truncated run."""
    out = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i}: unparseable record: {e}")
            if rec.get("v") != SCHEMA_VERSION:
                raise ValueError(
                    f"{path}:{i}: schema version {rec.get('v')!r}, "
                    f"expected {SCHEMA_VERSION}")
            kind = rec.get("kind")
            if kind not in KINDS:
                raise ValueError(f"{path}:{i}: unknown kind {kind!r}")
            if not isinstance(rec.get("step"), int):
                raise ValueError(f"{path}:{i}: missing integer step")
            if kind in ("count", "gauge", "histogram"):
                if not isinstance(rec.get("name"), str) \
                        or not isinstance(rec.get("value"), (int, float)):
                    raise ValueError(
                        f"{path}:{i}: {kind} record needs name + value")
            elif kind == "scalars":
                if not isinstance(rec.get("data"), dict):
                    raise ValueError(f"{path}:{i}: scalars record needs data")
            elif kind == "event":
                if not isinstance(rec.get("name"), str) \
                        or not isinstance(rec.get("data"), dict):
                    raise ValueError(
                        f"{path}:{i}: event record needs name + data")
            out.append(rec)
    return out


def replay(records: Sequence[Mapping[str, Any]],
           into: Optional[InMemoryTracker] = None) -> InMemoryTracker:
    """Aggregate :func:`read_jsonl` records into an :class:`InMemoryTracker`
    (counters summed, gauges last-write, histograms re-collected) so the
    jsonl artifact and a live in-memory capture answer the same queries."""
    t = into if into is not None else InMemoryTracker()
    for rec in records:
        kind = rec["kind"]
        if kind == "count":
            t.count(rec["name"], rec["value"], step=rec["step"])
        elif kind == "gauge":
            t.gauge(rec["name"], rec["value"], step=rec["step"])
        elif kind == "histogram":
            t.histogram(rec["name"], rec["value"], step=rec["step"])
        elif kind == "scalars":
            t.log(rec["data"], step=rec["step"])
        elif kind == "event":
            t.event(rec["name"], rec["data"], step=rec["step"])
    return t


class CompositeTracker(Tracker):
    """Fans every record out to child trackers in order (e.g. capture in
    memory AND persist to jsonl).  ``is_noop`` only when every child is."""

    def __init__(self, *children: Tracker) -> None:
        super().__init__()
        self.children = tuple(children)
        self.is_noop = all(c.is_noop for c in self.children)

    def count(self, name, value=1, *, step=None):
        for c in self.children:
            c.count(name, value, step=step)

    def gauge(self, name, value, *, step=None):
        for c in self.children:
            c.gauge(name, value, step=step)

    def histogram(self, name, value, *, step=None):
        for c in self.children:
            c.histogram(name, value, step=step)

    def log(self, metrics, *, step=None):
        for c in self.children:
            c.log(metrics, step=step)

    def event(self, name, data, *, step=None):
        for c in self.children:
            c.event(name, data, step=step)

    def time_block(self, name, *, step=None):
        if self.is_noop:
            return _NULL_SPAN
        return _Span(self, name, step)

    def finish(self):
        for c in self.children:
            c.finish()

    def _record(self, kind, name, value, data, step):  # pragma: no cover
        raise AssertionError("CompositeTracker dispatches per-primitive")
