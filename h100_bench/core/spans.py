"""The program's own spans in the CUDA-only traced window, for the readers
of host time, launches and syncs a render tile or a train step.

The port's `utils/profiling` keeps an in-memory record of its spans while
a profiler records (`record()`: name, parent, thread, start_ns and end_ns
each, under an index that counts every span it took). Each unit of a
traced window is one unit span (`render.frame` for a frame, `train_step`
for a step), so of the unit spans the record holds, the last
len(ctx.units) + len(ctx.host_units) are the two traced windows' in order,
and the first len(ctx.units) of those the CUDA-only window's, whose host
times no CPU profiler slowed. The benchmark takes the program's spans on
trust for host time: a span that moved would move these numbers.

The record keeps the newest spans (the oldest half goes when it fills),
so the windows' spans, the newest, are held whatever the process recorded
before them. A program without such a record (no `record()` in
`utils/profiling`) gives None; one whose record holds fewer unit spans than
the windows' units raises."""
from __future__ import annotations

import statistics
from typing import List, Optional, Sequence

# device ops that make the host wait for the device: a blocking copy from
# pageable host memory, and every copy back to the host
SYNC_OPS = ("Memcpy HtoD (Pageable", "Memcpy DtoH")


class WindowSpans:
    """The CUDA-only window's unit spans (`units`, indices into `record`)
    and the spans below them."""

    def __init__(self, record, units: List[int]):
        self.record, self.units = record, units
        self._under = set(units)

    def below(self, name: str) -> List[int]:
        """Indices of the closed spans named `name` that a window unit holds
        (its descendants on its own thread), in order."""
        rec, out = self.record, []
        for i in rec.closed(name):
            p = rec.parent[i - rec.first]
            while p >= rec.first and p not in self._under:
                p = rec.parent[p - rec.first]
            if p in self._under:
                out.append(i)
        return out

    def ms(self, idx: Sequence[int]) -> List[float]:
        return [self.record.ms(i) for i in idx]


def program_record():
    """The port's span record, or None where the program keeps none."""
    try:
        from real_robot_nerf_actor_tpu_torch.utils import profiling
    except ImportError:
        return None
    record = getattr(profiling, "record", None)
    return record() if callable(record) else None


def window(ctx, unit: str) -> Optional[WindowSpans]:
    """The CUDA-only window's `unit` spans; None where nothing ran on a
    device or the program keeps no span record."""
    if not ctx.trace.on_device:
        return None
    rec = program_record()
    if rec is None:
        return None
    units = rec.closed(unit)
    n, m = len(ctx.units), len(ctx.host_units)
    if len(units) < n + m:
        raise RuntimeError(f"the program's record holds {len(units)} {unit} spans where the "
                           f"traced windows ran {n} + {m} units")
    return WindowSpans(rec, units[len(units) - n - m:][:n])


def count(w: WindowSpans, name: str) -> int:
    """Spans named `name` below the window's units; raises where there are none."""
    k = len(w.below(name))
    if not k:
        raise RuntimeError(f"no {name} span in the traced window's units")
    return k


def device_ops(ctx) -> int:
    """Every device op of the CUDA-only trace: kernels, copies, sets."""
    return sum(c for _, c in ctx.trace.kernels.values())


def sync_ops(ctx) -> int:
    """The CUDA-only trace's copies that the host waits for."""
    return sum(c for name, (_, c) in ctx.trace.kernels.items()
               if name.startswith(SYNC_OPS))


def median_ms(w: WindowSpans, name: str) -> float:
    ms = w.ms(w.below(name))
    if not ms:
        raise RuntimeError(f"no {name} span in the traced window's units")
    return statistics.median(ms)
