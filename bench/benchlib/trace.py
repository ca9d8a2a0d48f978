"""What ``torch.profiler`` saw during the profiled ticks: the device's
busy time per tick, its operations by name, and its idle gaps by what
the host was doing.

The harness wraps each tick, and nothing inside it, in
``record_function("tick")``.  Every tick ends in a device synchronise,
so a device operation belongs to the tick whose host span holds its
start.  Busy time is the union of the device operations' intervals (a
copy of ``repro_torch.launch.profile_decode._busy_us``); an idle gap is a
stretch of a tick's span that no device operation covers, named by the
outermost host event (an ``aten::`` operation, or a CUDA runtime call
made outside one) running at its midpoint, or ``host python`` where
none runs.  The raw Kineto events are read, not
``prof.events()``, which builds a tree of every host event and takes
minutes at this many.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

TICK = "tick"
NAME_MAX = 96


@dataclass
class TickTrace:
    start_ns: int
    end_ns: int
    busy_ns: int = 0
    ops: Dict[str, int] = field(default_factory=dict)
    idle: Dict[str, int] = field(default_factory=dict)


def union_ns(intervals: Sequence[Tuple[int, int]]) -> int:
    """Total length of the union of (start, end) intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(intervals: Sequence[Tuple[int, int]], lo: int, hi: int
         ) -> List[Tuple[int, int]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


def top_level(spans: Sequence[Tuple[int, int, str]]
              ) -> List[Tuple[int, int, str]]:
    """The spans no other span holds, in time order (one thread's host
    operations nest)."""
    out, end = [], None
    for s, e, name in sorted(spans, key=lambda t: (t[0], -t[1])):
        if end is None or s >= end:
            out.append((s, e, name))
            end = e
    return out


def short(name: str) -> str:
    return name if len(name) <= NAME_MAX else name[:NAME_MAX - 3] + "..."


def summarize(events, labels: Dict[str, str]) -> List[TickTrace]:
    """One :class:`TickTrace` per ``tick`` span, in time order, from the
    raw Kineto ``events`` (``prof.profiler.kineto_results.events()``).
    ``labels`` maps a device name's prefix (an emitted kernel's
    ``kname``) to the name it is reported under."""
    import torch
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ticks, host, device, thread = [], [], [], None
    # (a user annotation's span on the device's timeline is no work; the
    # events' activity_type() is not reliable across torch versions)
    for e in events:
        dt = e.device_type()
        if dt == cpu:
            if e.name() == TICK:
                ticks.append(TickTrace(e.start_ns(), e.end_ns()))
                thread = e.start_thread_id()
            elif not e.is_user_annotation():
                host.append((e.start_ns(), e.end_ns(), e.name(),
                             e.start_thread_id()))
        elif dt == cuda and not e.is_user_annotation():
            name = e.name()
            for prefix, label in labels.items():
                if name.startswith(prefix):
                    name = label
                    break
            device.append((e.start_ns(), e.end_ns(), short(name)))
    ticks.sort(key=lambda t: t.start_ns)
    outer = top_level([(s, e, n) for s, e, n, th in host if th == thread])
    outer_starts = [s for s, _, _ in outer]
    starts = [t.start_ns for t in ticks]
    per_tick: List[List[Tuple[int, int]]] = [[] for _ in ticks]
    for s, e, name in device:
        i = bisect.bisect_right(starts, s) - 1
        if i < 0 or s > ticks[i].end_ns:
            continue
        per_tick[i].append((s, e))
        ticks[i].ops[name] = ticks[i].ops.get(name, 0) + (e - s)
    for t, ivs in zip(ticks, per_tick):
        clipped = [(max(s, t.start_ns), min(e, t.end_ns)) for s, e in ivs]
        t.busy_ns = union_ns(clipped)
        for s, e in gaps(clipped, t.start_ns, t.end_ns):
            mid = (s + e) // 2
            j = bisect.bisect_right(outer_starts, mid) - 1
            label = (outer[j][2] if j >= 0 and outer[j][1] >= mid
                     else "host python")
            t.idle[label] = t.idle.get(label, 0) + (e - s)
    return ticks


def top(parts: Sequence[Dict[str, int]], n: int = 10
        ) -> List[List]:
    """The ``n`` largest entries of the summed dicts, as ``[name,
    seconds]``."""
    total: Dict[str, int] = {}
    for d in parts:
        for k, v in d.items():
            total[k] = total.get(k, 0) + v
    best = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v / 1e9] for k, v in best]
