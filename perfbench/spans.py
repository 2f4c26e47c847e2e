"""The program's phase spans in torch.profiler's Chrome traces.

The port marks each call with a root span (``probunet.train_step``,
``probunet.sample``) and each phase of it with a span inside the root
(``probunet.pair``, ``.forward``, ``.backward``, ``.allreduce``,
``.optimizer``, ``.output``): ``record_function`` ranges, exported as
``user_annotation`` host events on the same timeline as the launches and
the device operations. A device operation belongs to a span when the
launch that created it (its correlation id) started inside one of the
span's intervals, on any thread: the autograd engine launches the backward
from its own thread while the calling thread waits inside
``probunet.backward``.

What the readers in ``metrics/`` share, on :class:`trace.Segment`:

- :func:`in_span`: a ``keep`` test for ``trace.pooled_ms`` and
  ``trace.launches_per_call``;
- :func:`host_ms`: a span's host time per call;
- :func:`idle_ms`: the device's idle time in the gaps ended by an
  operation launched in a span (the gap rule of ``Segment.idle_gaps``).

Each returns None where no segment holds the span, so a trace of a program
without spans reports nothing rather than 0.

The phase table, per span and per call: host ms, device ms, launches and
the idle ms behind it, over one or more traces taken as segments of one
run (the benchmark's traced segments, or the trainer's ``--profile_dir``
trace)::

    python3 -m perfbench.spans <trace.json>...
"""

from __future__ import annotations

import bisect
import copy
import json
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from perfbench import trace

PREFIX = "probunet."
ROOTS = ("probunet.train_step", "probunet.sample")
PHASES = ("probunet.pair", "probunet.forward", "probunet.backward", "probunet.allreduce",
          "probunet.optimizer", "probunet.output")
OUTSIDE = "(outside phases)"

Intervals = List[Tuple[float, float]]


def _merge(spans: List[Tuple[float, float]]) -> Intervals:
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def intervals(seg: trace.Segment, name: str, within: Optional[str] = None) -> Intervals:
    """The union of ``name``'s intervals on every thread; with ``within``,
    only those that start inside one of that span's intervals."""
    found = [(a, b) for ops in seg.host.values() for a, b, n in ops if n == name]
    if within is not None:
        outer = intervals(seg, within)
        found = [(a, b) for a, b in found if _holds(outer, a)]
    return _merge(found)


def _holds(ivs: Intervals, t: float) -> bool:
    j = bisect.bisect_right(ivs, (t, float("inf"))) - 1
    return j >= 0 and ivs[j][0] <= t <= ivs[j][1]


def present(segments: Sequence[trace.Segment], name: str) -> bool:
    return any(intervals(s, name) for s in segments)


def in_span(name: str, within: Optional[str] = None, exclude: Sequence[str] = ()):
    """``keep(seg, device_op)``: the operation's launch started inside
    ``name`` (inside ``within`` when given) and inside none of ``exclude``."""
    cache: Dict[int, Tuple[Intervals, List[Intervals]]] = {}

    def keep(seg: trace.Segment, d: tuple) -> bool:
        launch = seg.launch.get(d[3])
        if launch is None:
            return False
        if id(seg) not in cache:
            cache[id(seg)] = (intervals(seg, name, within),
                              [intervals(seg, x, within) for x in exclude])
        ivs, skip = cache[id(seg)]
        t = launch[1]
        return _holds(ivs, t) and not any(_holds(s, t) for s in skip)

    return keep


def host_ms(segments: Sequence[trace.Segment], name: str,
            within: Optional[str] = None) -> Optional[float]:
    """Host ms per call inside ``name``: its intervals' length over the calls."""
    if not present(segments, name):
        return None
    total = sum(b - a for s in segments for a, b in intervals(s, name, within))
    return total / 1e3 / sum(s.calls for s in segments)


def gaps(seg: trace.Segment) -> List[Tuple[Optional[tuple], float]]:
    """(the device operation that ends it, or None at the window's end,
    seconds) of each idle gap in the window, by ``Segment.idle_gaps``' rule."""
    out, prev = [], seg.t0
    nexts = iter(d for d in seg.device if d[1] > seg.t0)
    nxt = next(nexts, None)
    for a, b in seg._union() + [(seg.t1, seg.t1)]:
        if a > prev:
            while nxt is not None and nxt[0] < a:
                nxt = next(nexts, None)
            out.append((None if a >= seg.t1 else nxt, (a - prev) / 1e6))
        prev = max(prev, b)
    return out


def idle_ms(segments: Sequence[trace.Segment], keep) -> float:
    """Idle device ms, over all ``segments``, in gaps whose ending operation
    ``keep`` admits."""
    return 1e3 * sum(s for seg in segments for d, s in gaps(seg)
                     if d is not None and keep(seg, d))


def device_ms(segments: Sequence[trace.Segment], name: str) -> Optional[float]:
    """Device ms per call of the operations launched in ``name`` (pooled)."""
    return trace.pooled_ms(segments, in_span(name)) if present(segments, name) else None


def launches(segments: Sequence[trace.Segment], name: str) -> Optional[int]:
    """Kernels per call launched in ``name``."""
    return trace.launches_per_call(segments, in_span(name)) if present(segments, name) else None


def idle_pct(segments: Sequence[trace.Segment], name: str) -> Optional[float]:
    """Idle time behind ``name`` over the traced windows' wall time, in %."""
    if not present(segments, name):
        return None
    window = sum(s.window_s for s in segments)
    return 100.0 * idle_ms(segments, in_span(name)) / 1e3 / window


# ---- the phase table --------------------------------------------------------------------

def load(path: str) -> List[dict]:
    """A Chrome trace's events, with a ``perfbench.window`` around them all
    where the trace has none (the trainer's ``--profile_dir`` trace)."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    if not any(e.get("name") == trace.WINDOW for e in events):
        timed = [e for e in events if e.get("ph") == "X" and "ts" in e]
        t0 = min(float(e["ts"]) for e in timed)
        t1 = max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in timed)
        events = events + [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW,
                            "ts": t0, "dur": t1 - t0}]
    return events


def _top_idle_ops(segments, keep, n=3) -> str:
    """The host ops (innermost, spans aside) that launched the operations
    ending ``keep``'s gaps, with their idle ms over the traces."""
    tot: Dict[str, float] = defaultdict(float)
    for seg in segments:
        for d, s in gaps(seg):
            if d is not None and keep(seg, d):
                ops = [o for o in seg.host_ops_at(d[3]) if not o.startswith(PREFIX)]
                tot[ops[0] if ops else "(no host op)"] += s * 1e3
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return ", ".join(f"{k} {v:.1f}" for k, v in top)


def table(events_by_trace: Sequence[List[dict]]) -> List[dict]:
    """One row per root and phase: calls, host, device and idle ms per call,
    launches per call, and the host ops behind the idle gaps."""
    rows = []
    base = [trace.Segment(ev, 1) for ev in events_by_trace]
    for root in ROOTS:
        counts = [len(intervals(s, root)) for s in base]
        if not sum(counts):
            continue
        segs = []
        for s, n in zip(base, counts):
            if n:
                s = copy.copy(s)
                s.calls = n
                segs.append(s)
        calls = sum(s.calls for s in segs)
        names = [root] + [p for p in PHASES if any(intervals(s, p, root) for s in segs)]
        for name in names + [OUTSIDE]:
            if name == OUTSIDE:
                keep = in_span(root, exclude=[p for p in PHASES])
                host = host_ms(segs, root) - sum(r["host_ms"] for r in rows
                                                 if r["root"] == root and r["span"] != root)
            else:
                within = None if name == root else root
                keep = in_span(name, within)
                host = host_ms(segs, name, within)
            rows.append({"root": root, "span": name, "calls": calls, "host_ms": host,
                         "device_ms": trace.pooled_ms(segs, keep),
                         "launches": trace.launches_per_call(segs, keep),
                         "idle_ms": idle_ms(segs, keep) / calls,
                         "idle_behind": _top_idle_ops(segs, keep)})
    return rows


def main(argv=None) -> int:
    paths = sys.argv[1:] if argv is None else argv
    if not paths:
        print(__doc__.strip().splitlines()[-1].strip())
        return 2
    rows = table([load(p) for p in paths])
    if not rows:
        print("no probunet.* root span in the traces")
        return 1
    head = f"{'span':<22}{'calls':>6}{'host ms':>10}{'device ms':>11}{'launches':>10}{'idle ms':>9}"
    for root in ROOTS:
        part = [r for r in rows if r["root"] == root]
        if not part:
            continue
        print(f"\n{root} (per call)\n{head}  idle behind (host op, ms over the traces)")
        for r in part:
            name = r["span"] if r["span"] == root else "  " + r["span"].replace(PREFIX, "")
            print(f"{name:<22}{r['calls']:>6}{r['host_ms']:>10.3f}{r['device_ms']:>11.3f}"
                  f"{r['launches']:>10}{r['idle_ms']:>9.3f}  {r['idle_behind']}")
        if part[0]["device_ms"] > 0:
            print(f"the phases hold {100 * (1 - part[-1]['device_ms'] / part[0]['device_ms']):.2f}"
                  f" % of the root's device ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
