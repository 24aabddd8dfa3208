"""Profiling helpers (counterpart of the JAX package's
`utils/profiling.py`): named spans of the program's phases, a step timer
that waits for the device, and a `torch.profiler` trace of a block.

Spans. `named_scope(name)` marks a phase. With nothing collecting it is
one flag check that returns a shared null context: no
`record_function`, no NVTX range. Collection is on while a torch profiler
records (whatever its activities, CUDA alone included) or inside
`collect()`. A span then

- opens a profiler range of `name` (the user annotation that
  `torch.profiler.record_function` opens, entered through torch's own
  bindings where the build has them: a quarter of the public class's host
  time) where a profiler records, so the reference's cut points
  ("renderer_composite", "model_inference", ...) and the port's phases
  appear under their names in the trace; under
  `torch.autograd.profiler.emit_nvtx()` such a range is also an NVTX
  range, which an external profiler of the card reads;
- appends (name, parent, thread, start_ns, end_ns) to the in-memory
  record (`record()` while a profiler records, the block's own inside
  `collect()`): `parent` is the index of the span open around it on the
  same thread (-1 for none; each thread keeps its own stack, as a CUDA
  backward runs on autograd's device thread), and the times are
  `time.time_ns()`, the Unix-epoch clock of the profiler's events
  (`kineto_results.events()` start_ns / end_ns), taken just before the
  range opens and just after it closes: a span holds its range, a few us
  wider, and a trace's device ops can be put down to spans.

A record holds its spans in flat arrays of integers, so however many it
holds, the garbage collector has nothing of them to walk. It keeps the
newest `CAP`: when it is full it lets the oldest half go (`first` counts
what went, and indices keep counting), so `record()`, which lives as long
as the process and which every profiler session feeds, never stops taking
spans. `clear()` lets every span go. Nothing is written to disk.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from array import array
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

CAP = 1 << 18    # spans a record holds (a benchmark's two traced windows hold ~2.5 10^4)


class SpanRecord:
    """The newest spans, in the order they opened. Span i (an index that
    counts every span the record took) is held while i >= `first`; its
    end_ns is -1 while it is open."""

    def __init__(self):
        self.names: List[str] = []            # the distinct names, by id
        self._ids: Dict[str, int] = {}
        self.name_id = array("q")
        self.parent = array("q")
        self.thread = array("Q")
        self.start_ns = array("q")
        self.end_ns = array("q")
        self.first = 0
        self._lock = threading.Lock()
        self._local = threading.local()

    def __len__(self) -> int:
        return len(self.start_ns)

    def _stack(self) -> List[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _let_go(self, k: int) -> None:
        for col in (self.name_id, self.parent, self.thread, self.start_ns, self.end_ns):
            del col[:k]
        self.first += k

    def _open(self, name: str, start_ns: int) -> int:
        stack = self._stack()
        with self._lock:
            if len(self) >= CAP:
                self._let_go(len(self) - CAP // 2)
            nid = self._ids.get(name)
            if nid is None:
                nid = self._ids[name] = len(self.names)
                self.names.append(name)
            i = self.first + len(self)
            self.name_id.append(nid)
            self.parent.append(stack[-1] if stack else -1)
            self.thread.append(threading.get_ident())
            self.start_ns.append(start_ns)
            self.end_ns.append(-1)
        stack.append(i)
        return i

    def _close(self, i: int, end_ns: int) -> None:
        with self._lock:
            if i >= self.first:
                self.end_ns[i - self.first] = end_ns
        self._stack().pop()

    def clear(self) -> None:
        with self._lock:
            self._let_go(len(self))

    def span(self, i: int) -> Tuple[str, int, int, int, Optional[int]]:
        """(name, parent, thread, start_ns, end_ns) of held span i; end_ns
        None while it is open."""
        j = i - self.first
        if j < 0:
            raise IndexError(f"span {i} was let go (the oldest held is {self.first})")
        end = self.end_ns[j]
        return (self.names[self.name_id[j]], self.parent[j], self.thread[j],
                self.start_ns[j], None if end < 0 else end)

    def spans(self) -> Iterator[Tuple[int, str, int, int, int, Optional[int]]]:
        """(index, name, parent, thread, start_ns, end_ns) of every held
        span, oldest first."""
        for i in range(self.first, self.first + len(self)):
            yield (i,) + self.span(i)

    def closed(self, name: str) -> List[int]:
        """Indices of the held closed spans named `name`, in order."""
        nid = self._ids.get(name)
        return [self.first + j for j, (k, e) in enumerate(zip(self.name_id, self.end_ns))
                if k == nid and e >= 0]

    def ms(self, i: int) -> float:
        j = i - self.first
        return (self.end_ns[j] - self.start_ns[j]) / 1e6

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Each name's calls, total ms and self ms (its spans' durations
        less what their held children, on the same thread, cover), over
        the held closed spans."""
        done = [i for i, *_, end in self.spans() if end is not None]
        child_ms = [0.0] * len(self)
        for i in done:
            p = self.parent[i - self.first]
            if p >= self.first:
                child_ms[p - self.first] += self.ms(i)
        out: Dict[str, Dict[str, float]] = {}
        for i in done:
            j = i - self.first
            d = out.setdefault(self.names[self.name_id[j]],
                               {"calls": 0, "total_ms": 0.0, "self_ms": 0.0})
            ms = self.ms(i)
            d["calls"] += 1
            d["total_ms"] += ms
            d["self_ms"] += ms - child_ms[j]
        return out


_DEFAULT = SpanRecord()
_records: List[SpanRecord] = [_DEFAULT]   # the last is the one spans go to
_collecting = 0                           # open collect() blocks
_range = None                             # (enter, exit) of a profiler range, bound at first use


def record() -> SpanRecord:
    """The record that spans go to while a torch profiler records. It lives
    as long as the process and keeps the newest `CAP` spans; `clear()`
    empties it."""
    return _DEFAULT


@contextlib.contextmanager
def collect() -> Iterator[SpanRecord]:
    """Collect the block's spans, with or without a profiler, into a fresh
    record (yielded; `summary()` reads it)."""
    global _collecting
    rec = SpanRecord()
    _records.append(rec)
    _collecting += 1
    try:
        yield rec
    finally:
        _collecting -= 1
        _records.remove(rec)


def _range_bindings():
    """torch's enter and exit of a `record_function` range, without the
    public class's op dispatch; the public class's where a build lacks them."""
    global _range
    if _range is None:
        bindings = torch._C._autograd
        enter = getattr(bindings, "_record_function_with_args_enter", None)
        leave = getattr(bindings, "_record_function_with_args_exit", None)
        if enter is None or leave is None:
            def enter(name):
                r = torch.autograd.profiler.record_function(name)
                r.__enter__()
                return r

            def leave(r):
                r.__exit__(None, None, None)
        _range = (enter, leave)
    return _range


class _Span:
    __slots__ = ("name", "_range", "_rec", "_i")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        start = time.time_ns()
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = _range_bindings()[0](self.name)
        self._rec = _records[-1]
        self._i = self._rec._open(self.name, start)
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            _range_bindings()[1](self._range)
        self._rec._close(self._i, time.time_ns())
        return False


_OFF = contextlib.nullcontext()


def named_scope(name: str):
    """A span of the block named `name` (see the module's note): a shared
    null context unless a profiler records or `collect()` is open."""
    if _collecting or _autograd_profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF


def _sync(tree) -> None:
    """Synchronise the CUDA device of every tensor in `tree` (a tensor, or
    dicts, lists and tuples of them)."""
    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    for dev in devices:
        torch.cuda.synchronize(dev)


class StepTimer:
    """Wall-clock step timer that waits for the device before reading the
    clock: with StepTimer(sync_on=out) as t: ...; t.seconds. `sync_on` is a
    tensor or a tree of them (read when the block ends, so it may be filled
    inside it: pass a list and append to it)."""

    def __init__(self, sync_on: Optional[object] = None):
        self._sync_on = sync_on
        self.seconds = 0.0

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync_on is not None:
            _sync(self._sync_on)
        self.seconds = time.perf_counter() - self._start
        return False


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a `torch.profiler` trace (CPU, and CUDA where there is a card)
    of the block and write it into `log_dir` as a Chrome trace
    (`trace.json`). Yields the profiler, whose `key_averages()` the caller
    may read after the block."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
