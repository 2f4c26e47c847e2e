"""Readings from torch.profiler's Chrome traces.

A traced segment runs a few calls under the profiler inside a
``perfbench.window`` annotation that starts after a synchronise and ends
with one. From each segment's trace this module takes the device
operations (kernels, copies, fills), the host's CPU ops and the launches
that tie them (by correlation id). The estimators:

- ``pooled_ms``: a kernel's device time per call is its mean launch,
  pooled over the segments, times its launches per call (its count over
  the segment's calls, rounded, at its largest in any segment), summed
  over kernels. Late in a long trace the profiler drops records; that
  thins a mean but leaves it unbiased, and a kernel of earlier work rounds
  to 0 launches and is left out.
- ``launches_per_call``: the same launches per call, summed: a count.
- ``busy``: the union of device-operation intervals inside the window.
- ``alone_s``: the time inside the window in which a kernel that ``keep``
  admits runs and no other kernel does.
- ``idle_gaps``: the gaps of that union, each named by the innermost host
  op that launched the operation ending it.
"""

from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

WINDOW = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")


class Segment:
    """One traced segment: ``calls`` calls of the timed path."""

    def __init__(self, events: Sequence[dict], calls: int):
        self.calls = calls
        win = [e for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == WINDOW]
        if not win:
            raise ValueError(f"the trace has no {WINDOW!r} annotation")
        w = win[0]
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.device = []   # (ts, end, name, correlation, cat)
        self.launch = {}   # correlation -> (tid, ts)
        host = defaultdict(list)
        for e in events:
            cat = e.get("cat")
            if e.get("ph") != "X":
                continue
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                corr = (e.get("args") or {}).get("correlation")
                self.device.append((ts, ts + dur, e["name"], corr, cat))
            elif cat in LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    self.launch[corr] = (e.get("tid"), ts)
            elif cat in HOST_CATS and e.get("name") != WINDOW:
                host[e.get("tid")].append((ts, ts + dur, e["name"]))
        self.device.sort()
        self.host = {tid: sorted(v, key=lambda h: (h[0], -h[1])) for tid, v in host.items()}
        self._starts = {tid: [h[0] for h in v] for tid, v in self.host.items()}
        self._parent = {tid: _parents(v) for tid, v in self.host.items()}

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def kernels(self) -> List[tuple]:
        return [d for d in self.device if d[4] == "kernel"]

    def host_ops_at(self, corr) -> List[str]:
        """Names of the host ops enclosing the launch ``corr``, innermost first."""
        if corr not in self.launch:
            return []
        tid, ts = self.launch[corr]
        ops, parent = self.host.get(tid, []), self._parent.get(tid, [])
        out = []
        j = bisect.bisect_right(self._starts.get(tid, []), ts) - 1
        while j >= 0:   # ops on one thread nest: an op holding ts is an ancestor of j
            if ops[j][1] >= ts:
                out.append(ops[j][2])
            j = parent[j]
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self._union()) / 1e6

    def _union(self) -> List[Tuple[float, float]]:
        return [(a, b) for a, b in _union(((d[0], d[1]) for d in self.device), self.t0, self.t1)]

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """(what the host was doing, seconds) of each idle gap in the window."""
        union = self._union()
        out, prev = [], self.t0
        nexts = iter(d for d in self.device if d[1] > self.t0)
        nxt = next(nexts, None)
        for a, b in union + [(self.t1, self.t1)]:
            if a > prev:
                while nxt is not None and nxt[0] < a:
                    nxt = next(nexts, None)
                if a >= self.t1:
                    name = "(window end)"
                else:
                    ops = self.host_ops_at(nxt[3]) if nxt is not None else []
                    name = ops[0] if ops else "(no host op)"
                out.append((name, (a - prev) / 1e6))
            prev = max(prev, b)
        return out


def _union(intervals: Iterable[Tuple[float, float]], t0: float, t1: float) -> List[list]:
    """The union of ``intervals`` clipped to [t0, t1], sorted."""
    merged: List[list] = []
    for a, b in sorted(intervals):
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def alone_s(seg: Segment, keep) -> float:
    """Seconds of ``seg``'s window in which a kernel ``keep(seg, kernel)``
    admits runs and no other kernel does."""
    mine, others = [], []
    for k in seg.kernels():
        (mine if keep(seg, k) else others).append((k[0], k[1]))
    covered = _union(others, seg.t0, seg.t1)
    total, j = 0.0, 0
    for a, b in _union(mine, seg.t0, seg.t1):
        total += b - a
        while j < len(covered) and covered[j][1] <= a:
            j += 1
        i = j
        while i < len(covered) and covered[i][0] < b:
            total -= min(b, covered[i][1]) - max(a, covered[i][0])
            i += 1
    return total / 1e6


def _parents(ops: List[tuple]) -> List[int]:
    """Index of each op's enclosing op (-1 for none), ops sorted by start."""
    parent, stack = [], []
    for j, (a, b, _) in enumerate(ops):
        while stack and ops[stack[-1]][1] < a:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(j)
    return parent


def load_segment(path: str, calls: int) -> Segment:
    with open(path) as f:
        data = json.load(f)
    return Segment(data["traceEvents"] if isinstance(data, dict) else data, calls)


def kernel_filter(spec: dict) -> Callable[[Segment, tuple], bool]:
    """A test of a kernel by a ``kernels/*.json`` spec: its name matches one
    of ``names`` (regular expressions), or an enclosing host op is one of
    ``ops``."""
    pats = [re.compile(p) for p in spec.get("names", [])]
    ops = set(spec.get("ops", []))

    def test(seg: Segment, k: tuple) -> bool:
        if any(p.search(k[2]) for p in pats):
            return True
        return bool(ops) and any(o in ops for o in seg.host_ops_at(k[3]))

    return test


def _per_kernel(segments: Iterable[Segment], keep=None) -> Dict[str, List[Tuple[float, int, int]]]:
    seen: Dict[str, List[Tuple[float, int, int]]] = defaultdict(list)
    for seg in segments:
        tot: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
        for k in seg.kernels():
            if keep is None or keep(seg, k):
                t = tot[k[2]]
                t[0] += k[1] - k[0]
                t[1] += 1
        for name, (dur, n) in tot.items():
            seen[name].append((dur, n, seg.calls))
    return seen


def launches(counts: List[Tuple[float, int, int]]) -> int:
    return max(round(n / calls) for _, n, calls in counts)


def pooled_ms(segments: Sequence[Segment], keep=None) -> float:
    """Device ms per call of the kernels ``keep`` admits (all without it)."""
    total = 0.0
    for counts in _per_kernel(segments, keep).values():
        n = launches(counts)
        if n:
            total += sum(d for d, _, _ in counts) / sum(c for _, c, _ in counts) / 1e3 * n
    return total


def launches_per_call(segments: Sequence[Segment], keep=None) -> int:
    return sum(launches(c) for c in _per_kernel(segments, keep).values())


def top_device_ops(segments: Sequence[Segment], n: int = 10) -> List[list]:
    """[name, seconds] of the kernels with the most device time in the traces."""
    tot: Dict[str, float] = defaultdict(float)
    for seg in segments:
        for a, b, name, _, _ in seg.device:
            tot[name] += (b - a) / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def top_idle_gaps(segments: Sequence[Segment], n: int = 10) -> List[list]:
    """[host op, seconds] of the idle gaps, summed by what the host was doing."""
    tot: Dict[str, float] = defaultdict(float)
    for seg in segments:
        for name, s in seg.idle_gaps():
            tot[name] += s
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def roofline_pct(bound_s_per_call: float, device_ms_per_call: float) -> Optional[float]:
    """Share of the roofline in %: the least time over the time taken; None
    when nothing was timed."""
    if device_ms_per_call <= 0:
        return None
    return 100.0 * bound_s_per_call * 1e3 / device_ms_per_call
