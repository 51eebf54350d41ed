"""From a profiler trace (``.xplane.pb``) to what the metric readers read.

Device planes (``/device:...``) give, per device, the kernels that ran on
its streams; their union is the time the device was busy.  The lines XLA
derives from the same kernels ("XLA Ops", "XLA Modules", ...) are left out,
so nothing counts twice.  Host planes give the benchmark's own spans
(``jax.profiler.TraceAnnotation`` names that start with ``qbench.``): the
traced window and one span per query.  Host and device events share the
profiler's clock.
"""

from __future__ import annotations

import bisect
import re

SPAN_PREFIX = "qbench."
WINDOW_SPAN = "qbench.window"
QUERY_PREFIX = "qbench.query."
COLLECTIVE = re.compile(r"all-?reduce|all-?gather|reduce-?scatter|all-?to-?all|"
                        r"collective-?permute|nccl", re.I)


def load(path):
    """The reduced trace of one ``.xplane.pb`` file."""
    from jax.profiler import ProfileData
    data = ProfileData.from_file(path)
    devices, spans = {}, []
    for plane in data.planes:
        if plane.name.startswith("/device:"):
            events = []
            for line in plane.lines:
                if not line.name.startswith("Stream"):
                    continue
                for ev in line.events:
                    stats = dict(ev.stats)
                    name = stats.get("hlo_op") or ev.name
                    events.append((ev.start_ns, ev.start_ns + ev.duration_ns, str(name)))
            devices[plane.name] = events
        elif plane.name.startswith("/host:"):
            for line in plane.lines:
                for ev in line.events:
                    if ev.name.startswith(SPAN_PREFIX):
                        spans.append((ev.name, ev.start_ns, ev.start_ns + ev.duration_ns))
    return reduce(devices, spans)


def merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(devices, spans):
    """``devices``: {plane: [(start_ns, end_ns, op name)]}; ``spans``:
    [(name, start_ns, end_ns)] of the host.  Returns the busy union, the
    time per op and the collectives' union of each device, the traced
    window and the query spans in order."""
    out = {"devices": {}, "window": None, "queries": []}
    for plane, events in devices.items():
        if not events:
            continue
        ops = {}
        for s, e, name in events:
            ops[name] = ops.get(name, 0.0) + (e - s)
        busy = merge((s, e) for s, e, _ in events)
        coll = merge((s, e) for s, e, name in events if COLLECTIVE.search(name))
        out["devices"][plane] = {"busy": busy, "busy_starts": [a for a, _ in busy],
                                 "collective": coll,
                                 "collective_starts": [a for a, _ in coll], "ops": ops}
    for name, s, e in sorted(spans, key=lambda x: x[1]):
        if name == WINDOW_SPAN:
            out["window"] = [s, e]
        elif name.startswith(QUERY_PREFIX):
            out["queries"].append([name[len(QUERY_PREFIX):], s, e])
    return out


def covered(merged, starts, s, e):
    """Nanoseconds of [s, e) that the merged intervals (whose starts are
    ``starts``) cover."""
    i = max(bisect.bisect_right(starts, s) - 1, 0)
    total = 0.0
    for a, b in merged[i:]:
        if a >= e:
            break
        total += max(0.0, min(b, e) - max(a, s))
    return total


def gaps(merged, s, e):
    """The idle stretches of [s, e): [(start, end)] between busy intervals."""
    out, t = [], s
    for a, b in merged:
        if b <= s:
            continue
        if a >= e:
            break
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < e:
        out.append((t, e))
    return out


def window_busy(trace):
    """Nanoseconds of the traced window in which a device was busy, mean
    over the devices; None without a window or a device."""
    devs = list(trace["devices"].values())
    if not devs or trace["window"] is None:
        return None
    s, e = trace["window"]
    return sum(covered(d["busy"], d["busy_starts"], s, e) for d in devs) / len(devs)


def per_query(trace, key="busy"):
    """[(span ns, covered ns averaged over the devices)] per traced query."""
    devs = list(trace["devices"].values())
    if not devs:
        return []
    return [(e - s, sum(covered(d[key], d[key + "_starts"], s, e) for d in devs) / len(devs))
            for _, s, e in trace["queries"]]


def breakdown(trace, top=10):
    """The device ops that took most time (seconds per device) and the
    idle time of the window by what the host was doing: inside a query's
    span, or between queries."""
    devs = list(trace["devices"].values())
    if not devs or trace["window"] is None:
        return None
    ops = {}
    for d in devs:
        for name, ns in d["ops"].items():
            ops[name] = ops.get(name, 0.0) + ns / len(devs) / 1e9
    idle = {}
    ws, we = trace["window"]
    queries = trace["queries"]
    starts = [s for _, s, _ in queries]
    for d in devs:
        for a, b in gaps(d["busy"], ws, we):
            inside = 0.0
            for name, s, e in queries[max(bisect.bisect_right(starts, a) - 1, 0):]:
                if s >= b:
                    break
                part = max(0.0, min(b, e) - max(a, s))
                if part:
                    label = f"query.{name}"
                    idle[label] = idle.get(label, 0.0) + part / len(devs) / 1e9
                    inside += part
            idle["between_queries"] = (idle.get("between_queries", 0.0)
                                       + (b - a - inside) / len(devs) / 1e9)
    top_of = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": top_of(ops), "idle_gaps": top_of(idle)}
