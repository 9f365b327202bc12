"""Request tracing: span trees, a bounded collector, and wire propagation
(port of dnn_tpu/obs/trace.py, copied: its logic uses nothing of JAX,
so the same calls give the same spans, ids and tags).

This module gives every request a TRACE: a 64-bit trace id plus a
tree of timed spans (queue wait, admission, prefill, per-bucket decode,
per-hop RPC), collected into a bounded in-memory ring and exportable as
JSONL or Chrome-trace/Perfetto JSON (`chrome_trace`), so a single
request's 900 ms renders as a timeline instead of a mystery.

Propagation rides the EXISTING wire `request_id` field: a
`tr=<trace_id>.<span_id>` segment is appended (`tag_request_id`), which
every peer treats as opaque — the reference server relays request_id
verbatim, and our option parser skips unknown `key=value` segments
(lm_server.parse_gen_options) — so tracing is wire-compatible by
construction. Receivers parse the tag (`parse_wire_tag`) and parent
their spans under the sender's span, giving one tree across hops.

Cross-thread use (the LM batcher worker) passes parents EXPLICITLY
(`start_span(..., parent=...)`); same-thread code nests implicitly via
the contextvar-backed `span()` context manager. Everything degrades to
free no-ops when observability is off (dnn_tpu_torch/obs: DNN_TPU_OBS=off).
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import random
import threading
import time
from collections import deque
from typing import Iterator, Optional

__all__ = [
    "Span", "NULL_SPAN", "TraceCollector", "collector", "span",
    "start_span", "record_span", "current_span", "tag_request_id",
    "parse_wire_tag", "strip_wire_tag", "new_trace_id", "continue_or_start",
    "spans_to_chrome",
]

_rand = random.Random()  # stdlib PRNG: ids need uniqueness, not crypto
_rand.seed(os.urandom(16))
_id_lock = threading.Lock()

# perf_counter -> wall-clock epoch mapping, fixed once so every span of a
# process shares a consistent timeline
_EPOCH0 = time.time() - time.perf_counter()


def new_trace_id() -> str:
    with _id_lock:
        return f"{_rand.getrandbits(64):016x}"


def _new_span_id() -> str:
    with _id_lock:
        return f"{_rand.getrandbits(32):08x}"


class Span:
    """One timed operation. Created by `start_span`/`span`; `end()` stamps
    the duration and commits it to the collector. Attrs are plain
    JSON-able values; setattr-style mutation goes through `set()`."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "t0", "dur",
                 "attrs", "tid", "_done")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: Optional[str], attrs: dict):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs
        self.t0 = time.perf_counter()
        self.dur: Optional[float] = None
        self.tid = threading.get_ident()
        self._done = False

    def set(self, **attrs):
        self.attrs.update(attrs)
        return self

    def child(self, name: str, **attrs) -> "Span":
        return start_span(name, parent=self, **attrs)

    def end(self, **attrs):
        """Idempotent: the first call stamps and records; later calls are
        no-ops (retire paths and error paths may race to close)."""
        if self._done:
            return
        self._done = True
        if attrs:
            self.attrs.update(attrs)
        self.dur = time.perf_counter() - self.t0
        collector().add(self)

    # make `with start_span(...) as s:` work for explicit-parent spans
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id, "span_id": self.span_id,
            "parent_id": self.parent_id, "name": self.name,
            "ts": _EPOCH0 + self.t0, "dur": self.dur,
            "tid": self.tid, "attrs": self.attrs,
        }


class _NullSpan:
    """Free no-op stand-in when observability is off: every producer call
    site keeps its unconditional shape (`sp = start_span(...); sp.end()`)
    at the cost of a method dispatch, nothing else."""

    __slots__ = ()
    trace_id = None
    span_id = None
    parent_id = None
    name = "null"
    attrs: dict = {}
    dur = None

    def set(self, **attrs):
        return self

    def child(self, name, **attrs):
        return self

    def end(self, **attrs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False  # `if span:` selects the real-span path


NULL_SPAN = _NullSpan()

_current: "contextvars.ContextVar[Optional[Span]]" = contextvars.ContextVar(
    "dnn_tpu_torch_obs_span", default=None)


def current_span() -> Optional[Span]:
    return _current.get()


class TraceCollector:
    """Bounded ring of FINISHED spans (ended spans only — an abandoned
    span is dropped, never half-recorded). Capacity bounds memory on a
    week-long daemon; a traced burst beyond it keeps the newest spans."""

    def __init__(self, capacity: int = 16384):
        self._lock = threading.Lock()
        self._spans: "deque[Span]" = deque(maxlen=capacity)

    def add(self, s: Span):
        with self._lock:
            self._spans.append(s)

    def clear(self):
        with self._lock:
            self._spans.clear()

    def spans(self, trace_id: Optional[str] = None) -> list:
        with self._lock:
            out = list(self._spans)
        if trace_id is not None:
            out = [s for s in out if s.trace_id == trace_id]
        return out

    def trace_ids(self) -> list:
        """Distinct trace ids, oldest first."""
        seen: dict = {}
        for s in self.spans():
            seen.setdefault(s.trace_id, None)
        return list(seen)

    # -- exports --------------------------------------------------------

    def jsonl(self, trace_id: Optional[str] = None) -> str:
        return "".join(json.dumps(s.to_dict(), sort_keys=True) + "\n"
                       for s in self.spans(trace_id))

    def dump_jsonl(self, path: str, trace_id: Optional[str] = None):
        with open(path, "w") as f:
            f.write(self.jsonl(trace_id))

    def chrome_trace(self, trace_id: Optional[str] = None) -> dict:
        return spans_to_chrome([s.to_dict() for s in self.spans(trace_id)])


def spans_to_chrome(span_dicts: list) -> dict:
    """Span dicts (the JSONL schema) -> Chrome trace-event JSON: one
    complete ("ph":"X") event per span, timestamps in µs, one tid track
    per (thread, trace). Loads directly in Perfetto / chrome://tracing."""
    events = []
    tracks: dict = {}
    for d in span_dicts:
        key = (d["trace_id"], d["tid"])
        if key not in tracks:
            tracks[key] = len(tracks) + 1
            events.append({
                "ph": "M", "pid": 1, "tid": tracks[key],
                "name": "thread_name",
                "args": {"name": f"trace {d['trace_id'][:8]} "
                                 f"thread {d['tid']}"},
            })
        events.append({
            "name": d["name"], "cat": "dnn_tpu", "ph": "X",
            "ts": round(d["ts"] * 1e6, 3),
            "dur": round((d["dur"] or 0.0) * 1e6, 3),
            "pid": 1, "tid": tracks[key],
            "args": {**d["attrs"], "trace_id": d["trace_id"],
                     "span_id": d["span_id"],
                     "parent_id": d["parent_id"]},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


_collector = TraceCollector(
    int(os.environ.get("DNN_TPU_OBS_SPAN_CAP", "16384")))


def collector() -> TraceCollector:
    return _collector


# ----------------------------------------------------------------------
# producers
# ----------------------------------------------------------------------

def _enabled() -> bool:
    from dnn_tpu_torch import obs

    return obs.enabled()


def start_span(name: str, *, parent: Optional[Span] = None,
               trace_id: Optional[str] = None,
               parent_id: Optional[str] = None, **attrs):
    """Explicit span creation (cross-thread safe — no contextvar side
    effects). Parent resolution: explicit `parent` span > explicit
    (trace_id, parent_id) pair (a wire tag) > fresh root trace. Returns
    NULL_SPAN when observability is off."""
    if not _enabled():
        return NULL_SPAN
    if parent is not None and parent is not NULL_SPAN:
        trace_id, parent_id = parent.trace_id, parent.span_id
    elif trace_id is None:
        trace_id = new_trace_id()
    return Span(name, trace_id, _new_span_id(), parent_id, attrs)


def record_span(name: str, t0: float, dur: float, *,
                parent: Optional[Span] = None, **attrs):
    """Commit an already-measured interval (t0 = perf_counter at start)
    as a finished span — for producers that learn about an interval after
    the fact (queue wait is measured at dequeue time)."""
    if not _enabled():
        return NULL_SPAN
    s = start_span(name, parent=parent, **attrs)
    if s is not NULL_SPAN:
        s.t0 = t0
        s.tid = threading.get_ident()
        s._done = True
        s.dur = dur
        collector().add(s)
    return s


@contextlib.contextmanager
def span(name: str, **attrs) -> Iterator[Optional[Span]]:
    """Implicitly-nested span: parents under the calling context's span
    (same thread/task), and becomes the ambient parent for the body."""
    if not _enabled():
        yield None
        return
    s = start_span(name, parent=_current.get(), **attrs)
    tok = _current.set(s)
    try:
        yield s
    finally:
        _current.reset(tok)
        s.end()


# ----------------------------------------------------------------------
# wire propagation (the request_id tag)
# ----------------------------------------------------------------------

_TAG_PREFIX = "tr="


def tag_request_id(request_id: str, span) -> str:
    """Append/replace the trace tag on a wire request_id. Reference peers
    and the stage relay treat request_id as opaque; our parsers skip the
    segment — so tagging never changes wire behavior."""
    if span is None or span is NULL_SPAN or span.trace_id is None:
        return request_id
    base = strip_wire_tag(request_id)
    tag = f"{_TAG_PREFIX}{span.trace_id}.{span.span_id}"
    return f"{base}:{tag}" if base else tag


def strip_wire_tag(request_id: str) -> str:
    parts = [p for p in (request_id or "").split(":")
             if not p.startswith(_TAG_PREFIX)]
    return ":".join(parts)


def parse_wire_tag(request_id: str):
    """-> (trace_id, parent_span_id) or None. Tolerates a bare trace id
    (no '.<span_id>')."""
    for seg in (request_id or "").split(":"):
        if seg.startswith(_TAG_PREFIX):
            val = seg[len(_TAG_PREFIX):]
            tid, _, pid = val.partition(".")
            if tid:
                return tid, (pid or None)
    return None


def continue_or_start(name: str, request_id: str, **attrs):
    """Server-side root span for one handled request: CONTINUE the
    sender's trace when the request_id carries a `tr=` tag (the span
    parents under the sender's span, so one tree crosses the wire), else
    start a fresh trace. The one entry point every RPC handler uses
    (StageServer, LMServer). NULL_SPAN when observability is off."""
    link = parse_wire_tag(request_id or "")
    if link is not None:
        return start_span(name, trace_id=link[0], parent_id=link[1],
                          **attrs)
    return start_span(name, **attrs)
