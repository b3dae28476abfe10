"""The reduction of a traced slice to per-layer numbers: the device's
busy time and idle gaps, kernel time by name, and what the host was doing
in each gap (the innermost ``vio::`` range the harness had open).

Works on a ``torch.profiler`` Chrome trace (``export_chrome_trace``), whose
events carry microsecond start times and durations on one clock."""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SLICE = "vio::slice"


def load(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def merge(intervals):
    """Sorted, merged [start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events):
    """Device numbers of the slice that the ``vio::slice`` range spans:
    window_s, busy_s, kernel launches, device seconds and executions by name,
    and the idle
    seconds by the host range open at each gap's midpoint."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == SLICE]
    if not spans:
        return None
    w0 = float(spans[0]["ts"])
    w1 = w0 + float(spans[0]["dur"])
    dev, by_name, count, n_kernels = [], defaultdict(float), defaultdict(int), 0
    host = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            if s + d <= w0 or s >= w1:
                continue
            a, b = max(s, w0), min(s + d, w1)
            dev.append((a, b))
            by_name[e["name"]] += (b - a) * 1e-6
            count[e["name"]] += 1
            n_kernels += e.get("cat") == "kernel"
        elif str(e.get("name", "")).startswith("vio::") and e["name"] != SLICE:
            host.append((s, s + d, e["name"]))
    busy = merge(dev)
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    starts, names = innermost(host)
    idle = defaultdict(float)
    for a, b in gaps:
        i = bisect.bisect_right(starts, 0.5 * (a + b)) - 1
        idle[names[i] if i >= 0 else "vio::outside_calls"] += (b - a) * 1e-6
    return dict(window_s=(w1 - w0) * 1e-6, busy_s=sum(e - s for s, e in busy) * 1e-6,
                kernels=n_kernels, by_name=dict(by_name), count=dict(count),
                idle_by_host=dict(idle))


def innermost(ranges):
    """Segments of the host's timeline, each with the innermost of the nested
    ranges (start, end, name) open there: (segment starts, names), where
    "vio::outside_calls" marks time inside none."""
    bounds = sorted({t for s, e, _ in ranges for t in (s, e)})
    order = sorted(ranges, key=lambda r: (r[0], -r[1]))
    starts, names, stack, i = [], [], [], 0
    for t in bounds:
        while stack and stack[-1][1] <= t:
            stack.pop()
        while i < len(order) and order[i][0] <= t:
            if order[i][1] > t:
                stack.append(order[i])
            i += 1
        starts.append(t)
        names.append(stack[-1][2] if stack else "vio::outside_calls")
    return starts, names


def top(d, n=10):
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
