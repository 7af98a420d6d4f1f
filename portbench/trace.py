"""What a ``torch.profiler`` trace of the traced sub-window says: the
device operations, the union of their intervals, the device time by kernel
name and under named host ops, and the idle gaps by what the host was doing.

Busy time is the union of the device intervals (kernels, copies, sets) over
the traced window, so overlapping operations count once and the window
they are set against is the same traced window.
"""

from __future__ import annotations

import heapq
from collections import Counter


def _union(intervals: list) -> tuple[float, list]:
    """Total length of the union of ``(start, end)`` intervals, and the
    gaps between the merged intervals."""
    total, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            total += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total, gaps


def _labels(cpu: list, times: list) -> list:
    """The innermost host op running at each of the ascending ``times``
    (the latest-started one that has not ended), or ``host: python, no
    op``; ``cpu`` is ``(start, end, name)`` sorted by start."""
    out, heap, i = [], [], 0
    for t in times:
        while i < len(cpu) and cpu[i][0] <= t:
            heapq.heappush(heap, (-cpu[i][0], cpu[i][1], cpu[i][2]))
            i += 1
        while heap and heap[0][1] < t:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else "host: python, no op")
    return out


def summarize(events, window_s: float, named_host_ops: tuple = ()) -> dict:
    """Reduce a profiler's ``events()`` to the numbers the readers take.

    Returns ``device_ops`` (count), ``busy_s``, ``window_s``,
    ``kernel_s`` (device seconds by operation name), ``host_op_device_s``
    (device seconds under each of ``named_host_ops``, by the profiler's
    attribution of kernels to the host op that launched them) and
    ``breakdown`` (the ten operations with most device time, and idle
    gaps summed by what the host was doing)."""
    from torch.autograd import DeviceType

    dev, cpu = [], []
    kernel_s: Counter = Counter()
    host_op_s: Counter = Counter()
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            dev.append((tr.start, tr.end))
            kernel_s[e.name] += (tr.end - tr.start) * 1e-6
        elif e.device_type == DeviceType.CPU:
            cpu.append((tr.start, tr.end, e.name))
            if e.name in named_host_ops:
                host_op_s[e.name] += e.device_time_total * 1e-6
    busy_us, gaps = _union(dev)
    cpu.sort()
    idle: Counter = Counter()
    for (s, e), name in zip(gaps, _labels(cpu, [0.5 * (s + e) for s, e in gaps])):
        idle[name] += (e - s) * 1e-6
    return {
        "device_ops": len(dev),
        "busy_s": busy_us * 1e-6,
        "window_s": window_s,
        "kernel_s": dict(kernel_s),
        "host_op_device_s": dict(host_op_s),
        "breakdown": {
            "device_ops": [[k, v] for k, v in kernel_s.most_common(10)],
            "idle_gaps": [[k, v] for k, v in idle.most_common(10)],
        },
    }
