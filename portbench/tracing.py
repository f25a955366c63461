"""Reading a traced window: `torch.profiler` (CPU and CUDA activity) around
the measured calls, reduced to what the per-layer readers and the result
line need.

- The window is the span from the first `portbench.call` range to the end
  of the last, in the trace's own clock.
- Device work is every event the trace holds for a card (kernels,
  memcpys, memsets) but the copies of user ranges; a card's busy time is
  the UNION of those intervals inside the window (an upload on a side
  stream overlaps the kernels, so a sum would count it twice).
- An idle gap is a stretch of the window in which a card runs nothing; it
  is named by the innermost host operation of the calling thread that
  covers its middle ("python" where the thread is in no operation).
"""
from __future__ import annotations

import re
from collections import defaultdict

CALL = "portbench.call"
TOP = 10


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces and argument
    list; a copy's or a fill's name as it is."""
    if name.startswith(("Memcpy", "Memset")):
        return name[:200]
    name = name.replace("(anonymous namespace)::", "").split("(", 1)[0]
    return name.removeprefix("void ").strip()[:200]


def _annotation(e) -> bool:
    """A user range (record_function) rather than work: every version of
    the profiler's events marks those by `is_user_annotation`, the
    harness's own by their name."""
    flag = getattr(e, "is_user_annotation", None)
    return e.name() == CALL or bool(flag and flag())


def _union(intervals: list) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class Trace:
    """Device intervals, host operations and call ranges of one profile."""

    def __init__(self, prof):
        # card -> [(start, end, name)]; thread -> [(start, end, name)]
        self.device: dict = defaultdict(list)
        host: dict = defaultdict(list)
        calls = []
        for e in prof.profiler.kineto_results.events():
            start = e.start_ns()
            end = start + e.duration_ns()
            name = e.name()
            if _annotation(e):
                # a record_function range, and its copy on a card's timeline
                if name == CALL and "cpu" in str(e.device_type()).lower():
                    calls.append((start, end, e.start_thread_id()))
            elif "cuda" in str(e.device_type()).lower():
                self.device[e.device_index()].append((start, end, name))
            else:
                host[e.start_thread_id()].append((start, end, name))
        if not calls:
            raise RuntimeError("the trace holds no measured call")
        self.t0 = min(c[0] for c in calls)
        self.t1 = max(c[1] for c in calls)
        self.host = host.get(calls[0][2], [])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def _clipped(self, card: int) -> list:
        return [(max(s, self.t0), min(e, self.t1), n)
                for s, e, n in self.device.get(card, [])
                if e > self.t0 and s < self.t1]

    def busy_s(self, card: int) -> float:
        return sum(e - s for s, e in
                   _union([(s, e) for s, e, _ in self._clipped(card)])) / 1e9

    def seconds(self, pattern: str, card: int | None = None) -> float:
        """Device seconds in the window of work whose name matches."""
        rx = re.compile(pattern)
        cards = [card] if card is not None else list(self.device)
        return sum(e - s for c in cards for s, e, n in self._clipped(c)
                   if rx.search(n)) / 1e9

    def count(self, pattern: str) -> int:
        rx = re.compile(pattern)
        return sum(1 for c in self.device for _, _, n in self._clipped(c)
                   if rx.search(n))

    def device_ops(self, cards: list) -> list:
        """The device operations that took most time: [[name, seconds]]."""
        tot: dict = defaultdict(float)
        for c in cards:
            for s, e, n in self._clipped(c):
                tot[short_name(n)] += (e - s) / 1e9
        return [[n, t] for n, t in
                sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self, cards: list) -> list:
        """Idle seconds by what the host was doing, averaged over `cards`:
        [[host operation, seconds]]."""
        tot: dict = defaultdict(float)
        ops = sorted(self.host)
        for c in cards:
            busy = _union([(s, e) for s, e, _ in self._clipped(c)])
            edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
            gaps = sorted((a, b) for a, b in zip(edges[::2], edges[1::2])
                          if b > a)
            stack: list = []
            i = 0
            for a, b in gaps:
                mid = (a + b) // 2
                while i < len(ops) and ops[i][0] <= mid:
                    while stack and stack[-1][1] <= ops[i][0]:
                        stack.pop()
                    stack.append(ops[i])
                    i += 1
                while stack and stack[-1][1] < mid:
                    stack.pop()
                tot[stack[-1][2][:200] if stack else "python"] += \
                    (b - a) / 1e9 / len(cards)
        return [[n, t] for n, t in
                sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]]


class Context:
    """What a per-layer reader may read: the trace, the window's counts,
    the port's counters, and the cell's configuration and traffic."""

    def __init__(self, trace: Trace, cards: list, config: dict,
                 traffic: dict, calls: int, images: int, scan_bytes: int,
                 counters: dict):
        self.trace, self.cards = trace, cards
        self.config, self.traffic = config, traffic
        self.calls, self.images, self.scan_bytes = calls, images, scan_bytes
        self.counters = counters

    @property
    def window_s(self) -> float:
        return self.trace.window_s
