"""The traced window: device time by kernel and by host range, the device's
busy time and its longest idle gaps, read from a `torch.profiler` trace of
CPU and CUDA activity."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple


@dataclasses.dataclass
class Trace:
    window_s: float                       # host clock over the traced units
    busy_s: float                         # union of device activity
    kernels: Dict[str, Tuple[float, int]]  # device op -> (seconds, launches)
    ranges: Dict[str, Tuple[float, int]]  # host range -> (device seconds inside, calls)
    gaps: List[Tuple[str, float]]         # longest idle gaps, by host range
    on_device: bool = True                # whether any device activity was traced

    def kernel_seconds(self, needles: Sequence[str]) -> Tuple[float, int]:
        """Device seconds and launches of the ops whose name holds a needle."""
        t = n = 0
        for name, (s, c) in self.kernels.items():
            if any(k in name for k in needles):
                t += s
                n += c
        return t, n

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:top]
        return {"device_ops": [[k[:160], s] for k, (s, _) in ops],
                "idle_gaps": [[k, s] for k, s in self.gaps[:top]]}


def read_profile(prof, window_s: float) -> Trace:
    """Reduce a finished `torch.profiler.profile` over the traced window,
    from its raw events (building the profiler's event tree takes minutes
    for a window of a few hundred thousand ops). A device op belongs to a
    host range when the host launched it inside the range."""
    import bisect

    from torch.autograd import DeviceType

    launched: Dict[int, int] = {}
    host: Dict[str, List[Tuple[int, int]]] = {}
    device: List[Tuple[int, int, str, int]] = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            if e.is_user_annotation():
                host.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
            elif e.correlation_id():
                launched[e.correlation_id()] = e.start_ns()
        elif not e.is_user_annotation():
            device.append((e.start_ns(), e.end_ns(), e.name(), e.linked_correlation_id()))
    kernels: Dict[str, Tuple[float, int]] = {}
    in_range: Dict[str, float] = dict.fromkeys(host, 0.0)
    spans = {name: sorted(v) for name, v in host.items()}
    starts = {name: [a for a, _ in v] for name, v in spans.items()}
    for a, b, name, corr in device:
        s, n = kernels.get(name, (0.0, 0))
        kernels[name] = (s + (b - a) / 1e9, n + 1)
        t = launched.get(corr)
        if t is None:
            continue
        for rname, v in spans.items():
            j = bisect.bisect_right(starts[rname], t) - 1
            if j >= 0 and t <= v[j][1]:
                in_range[rname] += (b - a) / 1e9
    ranges = {k: (in_range[k], len(v)) for k, v in host.items()}
    merged = _union([(a, b) for a, b, _, _ in device])
    busy = sum(b - a for a, b in merged) / 1e9
    longest = sorted(((start - end, end, start) for (_, end), (start, _)
                      in zip(merged, merged[1:])), reverse=True)[:10]
    flat = [(a, b, name) for name, v in spans.items() for a, b in v]
    gaps = []
    for length, end, start in longest:
        mid = (end + start) / 2
        inside = [h for h in flat if h[0] <= mid <= h[1]]
        label = min(inside, key=lambda h: h[1] - h[0])[2] if inside else "host"
        gaps.append((label, length / 1e9))
    return Trace(window_s=window_s, busy_s=busy, kernels=kernels, ranges=ranges,
                 gaps=gaps, on_device=bool(device))


def _union(intervals):
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out
