"""Host spans inside the port's forward, recorded in memory.

Off by default.  Within ``with recording() as rec:`` every span site the
program reaches opens and closes a span, and ``rec.drain()`` returns
(and clears) what was recorded as :class:`Span` objects, in the order
the spans began.  There is no exporter, file or environment switch: a
reader places the spans itself (``portbench/attribution.py`` puts a
device trace's work under them).

The sites, and the kinds of span they record (:data:`KINDS`):

* ``forward`` — one chained forward (`exec.run._forward`, reached by
  ``execute_plan``, ``execute_looped`` and ``execute_oracle``); it opens
  a new forward id, which every span under it carries;
* ``layer`` — one planned layer (`exec.run._segment`), named by the
  layer, carrying its executor, which every span under it inherits;
* ``exec`` — the call of the layer's planned executor;
* ``attention`` — the attention stage after a fused qkv projection;
* ``glue`` — a glue stage, named ``fit``, ``layernorm``, ``act`` or
  ``carry`` (concat or residual add);
* ``kernel`` — one launch of a hand-written kernel
  (`kernels._build.launch`), named by its C entry point.

Times are ``time.perf_counter_ns()``.  Each thread records into a store
of its own, with its own stack of open spans, so a second thread's spans
never nest under the first's.  Off, a site costs one test of a
module-level flag and allocates nothing.  On, a span is a few values
appended to its thread's lists, none of them an object the garbage
collector tracks: a span object each would make the collector run
during the forward, and a full collection of a process holding torch
stalls the host for ~0.1 s."""
from __future__ import annotations

import itertools
import threading
from contextlib import contextmanager
from time import perf_counter_ns
from typing import Iterator, List, Optional

KINDS = ("forward", "layer", "exec", "attention", "glue", "kernel")
FIELDS = ("id", "parent", "forward", "kind", "name", "executor", "start",
          "end")

_on = False
_ids = itertools.count(1)
_forwards = itertools.count(1)
_local = threading.local()
_stores: List["_Store"] = []
_stores_lock = threading.Lock()


class Span:
    """One recorded span.  ``parent`` and ``forward`` are None outside
    any span and outside any forward; ``executor`` is the enclosing
    layer's; ``end`` stays None where an exception cut the span short."""

    __slots__ = FIELDS

    def __init__(self, *values):
        for f, v in zip(FIELDS, values):
            setattr(self, f, v)

    def __repr__(self) -> str:
        return (f"Span({self.id}, {self.kind}:{self.name}, parent="
                f"{self.parent}, forward={self.forward}, "
                f"executor={self.executor})")


class _Store:
    """One thread's spans, a list per field, and its open spans' rows."""

    __slots__ = FIELDS + ("open",)

    def __init__(self):
        self.clear()

    def clear(self) -> None:
        for f in FIELDS + ("open",):
            setattr(self, f, [])


def _store() -> _Store:
    """This thread's store, made (and registered) on first use."""
    try:
        return _local.store
    except AttributeError:
        st = _local.store = _Store()
        with _stores_lock:
            _stores.append(st)
        return st


def begin(kind: str, name: str, executor: Optional[str] = None
          ) -> Optional[int]:
    """Open a span under this thread's innermost open one; returns its
    row for :func:`end`, or None (and records nothing) while the
    recorder is off."""
    if not _on:
        return None
    try:
        st = _local.store
    except AttributeError:
        st = _store()
    opened = st.open
    if opened:
        up = opened[-1]
        parent, forward = st.id[up], st.forward[up]
        if executor is None:
            executor = st.executor[up]
    else:
        parent = forward = None
    if kind == "forward":
        forward = next(_forwards)
    row = len(st.start)
    st.id.append(next(_ids))
    st.parent.append(parent)
    st.forward.append(forward)
    st.kind.append(kind)
    st.name.append(name)
    st.executor.append(executor)
    st.end.append(None)
    opened.append(row)
    st.start.append(perf_counter_ns())
    return row


def end(row: Optional[int]) -> None:
    """Close the span :func:`begin` returned (a no-op for None) and any
    span still open under it, which an exception left open."""
    if row is None:
        return
    t = perf_counter_ns()
    st = _local.store
    if row < len(st.end):
        st.end[row] = t
    opened = st.open
    while opened and opened.pop() != row:
        pass


class Recorder:
    """The handle :func:`recording` yields."""

    def drain(self) -> List[Span]:
        """Every span recorded since the last drain, in the order they
        began, as :class:`Span` objects; the recorder keeps none of
        them.  Drain once the recorded calls have returned."""
        out = []
        with _stores_lock:
            for st in _stores:
                out += map(Span, *(getattr(st, f) for f in FIELDS))
                st.clear()
        out.sort(key=lambda s: s.start)
        return out


@contextmanager
def recording() -> Iterator[Recorder]:
    """Record spans for the block (in every thread); not reentrant.
    Spans not drained from an earlier block are dropped."""
    global _on
    if _on:
        raise RuntimeError("the span recorder is already recording")
    with _stores_lock:
        for st in _stores:
            st.clear()
    _on = True
    try:
        yield Recorder()
    finally:
        _on = False
