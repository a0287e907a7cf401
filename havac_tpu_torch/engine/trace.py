"""Host spans of the engine: one helper that times a phase into its
``pipeline_prof`` counter and, while a profiler records, marks the phase
in the profiler's trace on Kineto's clock, the clock of the kernels and
copies.

A named span is a leaf: no span encloses another, so a reader that names
a device idle gap by the host event overlapping it most finds the phase
itself. A span without a name only counts; ``gate_wait``, ``drain``,
``tail`` and the sweep's wall enclose named spans that way.

Every counter of ``pipeline_prof`` holds seconds but four, which count:
``tail_segments`` counts the (chunk, row) segments that the tail placed by
the chunks' rectangles (`engine/pipeline.py` `_merge_resolved`; 0 where it
merged by comparison), and is also the ``segments`` argument of the
``havac.tail.gather`` span. ``havac.tail.merge`` times the plan of that
placement, or the comparison merge, and ``havac.tail.gather`` the copy.
``launches`` counts the ``havac.launch`` spans, whose seconds are
``dispatch``; a regrow's relaunch runs under ``havac.regrow`` and is not
counted. Each launch carries its alphabet's size (``card``), the
number of model starts among its rows that reset the chain (``resets``)
and the number of its 16-row hit windows that hold one
(``reset_windows``: only those run the kernel's reset test); the counter
``reset_windows`` sums the last over the launches. ``launched_ahead``
counts a ``scan_files`` file's launches enqueued before the previous file
was yielded (`engine/api.py`): its ``havac.launch`` spans lie beside the
previous request's tail and ``havac.hits``, on another thread.

``Havac.load_phmm`` times its two halves apart from any search, into
``Havac.load_prof``: ``parse`` (span ``havac.load.parse``, the ``.hmm``
read) and ``project`` (``havac.load.project``, the projection).

Spans are recorded whenever a ``torch.profiler`` session runs, on every
thread it profiles; nothing else turns them on. The guard is
``torch.autograd.profiler._is_profiler_enabled``, which the profiler sets
for the whole process: the C++ flag (``torch._C._autograd.
_profiler_enabled``) reads False on the threads that all-threads profiling
picks up. Without a profiler a span costs its two clock reads and that
flag read.

Kineto's Chrome trace carries no arguments of a ``record_function``, so
each recorded span's arguments (its request and, for a launch, its chunk)
are kept in memory and merged into the trace by :func:`export_chrome_trace`,
matched to the span's event by thread and name, in order.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from typing import Dict, List, Optional, Tuple

from torch.autograd import profiler as _autograd_profiler

# (thread, name, args) of every span recorded since the last export, in
# the order each thread entered them; bounded for a session that is never
# exported through this module.
_ARGS: List[Tuple[int, str, dict]] = []
_MAX_ARGS = 1 << 20


class span:
    """``with span(name, prof, key, **args):`` adds the block's seconds to
    ``prof[key]`` (under ``lock`` where threads share ``prof``) and, while
    a profiler records, enters ``record_function(name)`` around it.
    :meth:`split` charges the seconds so far to another counter."""

    __slots__ = ("name", "prof", "key", "lock", "args", "t0", "_record")

    def __init__(self, name: Optional[str], prof: Dict[str, float],
                 key: str, lock: Optional[threading.Lock] = None,
                 **args) -> None:
        self.name = name
        self.prof = prof
        self.key = key
        self.lock = lock
        self.args = args

    def __enter__(self) -> "span":
        self._record = None
        if self.name is not None and _autograd_profiler._is_profiler_enabled:
            self._record = _autograd_profiler.record_function(self.name)
            self._record.__enter__()
            if len(_ARGS) < _MAX_ARGS:
                _ARGS.append((threading.get_native_id(), self.name,
                              self.args))
        self.t0 = time.perf_counter()
        return self

    def split(self, key: str) -> None:
        t = time.perf_counter()
        self._add(key, t - self.t0)
        self.t0 = t

    def __exit__(self, *exc) -> None:
        self._add(self.key, time.perf_counter() - self.t0)
        if self._record is not None:
            self._record.__exit__(*exc)

    def _add(self, key: str, seconds: float) -> None:
        if self.lock is None:
            self.prof[key] += seconds
        else:
            with self.lock:
                self.prof[key] += seconds


def profiler(activities):
    """A ``torch.profiler.profile`` over every thread where this torch can
    (the sweep worker, the scan producer and the collector pool run on
    their own), as the benchmark harness profiles; forgets the arguments
    of spans recorded before it."""
    from torch.profiler import profile

    _ARGS.clear()
    try:
        from torch.profiler import _ExperimentalConfig

        extra = {"experimental_config":
                 _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        extra = {}
    return profile(activities=activities, **extra)


def export_chrome_trace(prof, path: str) -> None:
    """Write ``prof``'s Chrome trace to ``path`` with each span's arguments
    in its event's ``args``."""
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    queues: Dict[Tuple[int, str], collections.deque] = {}
    for tid, name, args in _ARGS:
        queues.setdefault((tid, name), collections.deque()).append(args)
    _ARGS.clear()
    events = sorted((e for e in trace["traceEvents"]
                     if e.get("cat") == "user_annotation"
                     and (e.get("tid"), e.get("name")) in queues),
                    key=lambda e: float(e["ts"]))
    for e in events:
        q = queues[e["tid"], e["name"]]
        if q:
            e.setdefault("args", {}).update(q.popleft())
    with open(path, "w") as f:
        json.dump(trace, f)
