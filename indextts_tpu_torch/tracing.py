"""Spans inside the program: what the host was doing while a profiler ran.

`span(name, **attrs)` is a context manager around one piece of host work
(an admission, a decode loop, a block's replay and read, a vocoder batch).
It records only while a torch.profiler is running on the calling thread
(`IndexTTS.start_profiling`, or any `torch.profiler.profile` window):

* off, the one check `torch._C._autograd._profiler_enabled()` (about 0.2 us)
  and one shared no-op object; no range, no clock read, no record;
* on, a `record_function(name)` range in the profiler, so that an exported
  trace, and any reader of the profiler's events, shows the span on the
  device trace's clock; and a record on `time.perf_counter_ns()`, the clock
  a caller's own timers read, kept in one bounded ring (`spans()`).

A record is `Span(id, parent, name, t0, t1, attrs)`: `parent` is the id of
the span open around it on its thread (0 for none), `t0` / `t1` are
perf_counter nanoseconds and `attrs` the values the caller gave, or set on
the yielded object before exit (`set(**attrs)`). The profiler's range and
the record are the same span: the n-th range of a name is the n-th record of
that name, nested alike. The profiler stamps its events on another clock
(Unix-epoch nanoseconds), so the two are joined by name, order and nesting,
never by time.

Where the program places spans, it keeps three rules: an attribute is a
value the host already holds (never a device tensor, which would make the
host wait); no span sits inside a function that a graph stage captures or
replays (a step, a block's head or body, a called function), since a capture
runs it once and a replay not at all; and spans nest on their thread.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, Dict, List, NamedTuple

import torch
from torch.autograd.profiler import record_function

# the records the ring keeps, the newest last
RING = 65536

_enabled = torch._C._autograd._profiler_enabled
_clock = time.perf_counter_ns
_range = record_function
_ring: "deque[Span]" = deque(maxlen=RING)
_ids = itertools.count(1)
_local = threading.local()


class Span(NamedTuple):
    id: int
    parent: int
    name: str
    t0: int
    t1: int
    attrs: Dict[str, Any]


class _Off:
    """What span() returns while no profiler runs: enters nothing, keeps nothing."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _On:
    """One recorded span: a profiler range and a ring record."""

    __slots__ = ("name", "attrs", "id", "parent", "t0", "_rf")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> "_On":
        stack = _stack()
        self.parent = stack[-1].id if stack else 0
        self.id = next(_ids)
        # the record brackets the range: a profiler's first range of a window
        # can take a millisecond to enter, which the record then holds too
        self.t0 = _clock()
        self._rf = _range(self.name)
        self._rf.__enter__()
        stack.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        _stack().pop()
        self._rf.__exit__(*exc)
        _ring.append(Span(self.id, self.parent, self.name, self.t0, _clock(), self.attrs))
        return False

    def set(self, **attrs) -> None:
        """Attributes known only at the end of the span (steps run, say)."""
        self.attrs.update(attrs)


def _stack() -> List[_On]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, **attrs):
    """A span `name` around the `with` block, recorded while a profiler runs
    on this thread; the yielded object is false when nothing is recorded."""
    if not _enabled():
        return _OFF
    return _On(name, attrs)


def current():
    """The innermost span open on this thread (to `set` attributes of a span
    opened by a caller), or the no-op object."""
    stack = getattr(_local, "stack", None) if _enabled() else None
    return stack[-1] if stack else _OFF


def spans() -> List[Span]:
    """The ring's records, oldest first (at most RING)."""
    return list(_ring)


def clear() -> None:
    _ring.clear()
