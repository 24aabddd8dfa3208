"""The measured window and what the per-layer readers see of it."""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
from typing import Callable, List, Optional

import torch

from h100_bench.core.kernels import KERNEL_NAMES
from h100_bench.core.peaks import PEAK_OPS_PER_S, least_seconds
from h100_bench.core.stats import rate
from h100_bench.core.trace import Trace


@dataclasses.dataclass
class Record:
    """Each unit of work of a window: its index, start and end (host clock,
    seconds from the window's start) and the work it completed."""
    index: List[int]
    starts: List[float]
    ends: List[float]
    work: List[float]
    window_s: float

    def rate(self) -> float:
        return rate(self.work, self.window_s)

    def latencies(self) -> List[float]:
        return [e - s for s, e in zip(self.starts, self.ends)]


@contextlib.contextmanager
def phase(name: str, device=None):
    """Time a phase of set-up to standard error (`setup <name> <seconds>`)."""
    t = time.perf_counter()
    yield
    if device is not None:
        sync(device)
    print(f"setup {name} {time.perf_counter() - t:.3f}", file=sys.stderr, flush=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_window(step: Callable[[], float], seconds: float, device,
               clock: Callable[[], float] = time.perf_counter) -> Record:
    """Closed loop: `step()` again and again until `seconds` have passed;
    the window ends when the last step's work is done on the device."""
    sync(device)
    t0 = clock()
    rec = Record([], [], [], [], 0.0)
    i = 0
    while True:
        s = clock()
        if s - t0 >= seconds:
            break
        with torch.profiler.record_function("bench.unit"):
            n = step()
        rec.index.append(i)
        rec.starts.append(s - t0)
        rec.ends.append(clock() - t0)
        rec.work.append(n)
        i += 1
    sync(device)
    rec.window_s = clock() - t0
    return rec


class LayerContext:
    """What a per-layer metric's reader reads: the trace of the traced
    window, its units, and the cell (its kernels' work by unit, its model
    operations by unit). Readers return None where there is nothing to
    read (every device metric, where nothing ran on a device), and raise
    where a kernel the cell launches is missing."""

    def __init__(self, trace: Trace, cell, units: List[int],
                 host_trace: Optional[Trace] = None, host_units: Optional[List[int]] = None):
        self.trace, self.cell, self.units = trace, cell, units
        # the window traced with the host's ops too: its host ranges
        self.host_trace = host_trace if host_trace is not None else trace
        self.host_units = host_units if host_units is not None else units

    def _launches(self, kernel: str):
        """(the work of each of the kernel's launches by the cell's shapes,
        their device seconds); None where the cell does not launch it or
        nothing ran on a device. Raises where the trace's launches differ
        from the shapes'."""
        works = [w for i in self.units for w in self.cell.unit_work(i).get(kernel, [])]
        if not works or not self.trace.on_device:
            return None
        seconds, launches = self.trace.kernel_seconds(KERNEL_NAMES[kernel])
        if launches != len(works):
            raise RuntimeError(f"{kernel}: the trace shows {launches} launches where the "
                               f"cell's shapes give {len(works)}")
        return works, seconds

    def roofline(self, kernel: str) -> Optional[float]:
        """100 x the least time of the kernel's launches over their device
        time, each summed over the window."""
        got = self._launches(kernel)
        if got is None:
            return None
        works, seconds = got
        return 100.0 * sum(least_seconds(*w) for w in works) / seconds

    def kernel_ms(self, kernel: str) -> Optional[float]:
        """Device ms a unit of the kernel's launches."""
        got = self._launches(kernel)
        return None if got is None else got[1] / len(self.units) * 1e3

    def range_ms(self, name: str) -> Optional[float]:
        """Device ms a unit of the kernels launched inside host range `name`."""
        h = self.host_trace
        if name not in h.ranges or not h.on_device:
            return None
        return h.ranges[name][0] / len(self.host_units) * 1e3

    def idle_share(self) -> Optional[float]:
        if not self.trace.on_device:
            return None
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.window_s)

    def mfu(self) -> Optional[float]:
        """100 x the window's model operations at their dtypes' peaks over
        the window's length."""
        if not self.trace.on_device:
            return None
        t = 0.0
        for i in self.units:
            t += sum(n / PEAK_OPS_PER_S[dt] for dt, n in self.cell.unit_model_ops(i).items())
        return 100.0 * t / self.trace.window_s
