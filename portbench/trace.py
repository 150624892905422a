"""Spans in memory, the profiled sub-window, and the reduction of a device
trace to busy time, idle gaps and kernel times.

The device records come from ``torch.profiler`` (CUPTI), read from its raw
events as ``gaussianprocessnode_tpu_torch/utils/profiling.py``'s
``cuda_kernel_times`` reads them (its arithmetic, copied and extended from
sums by kernel name to the timeline). The benchmark's own spans (handle
call, synchronize, chunk, host read) are taken on the wall clock, the
profiler's, so that they label the trace's idle gaps.
"""

import contextlib
import json
import time
import warnings
from dataclasses import dataclass, field

NOT_KERNELS = ("Memcpy", "Memset")


def union(intervals):
    """Merged, sorted, disjoint intervals covering the given (start, end)s."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def busy(intervals, lo, hi) -> float:
    """Length of the union of the intervals inside [lo, hi]."""
    return sum(e - s for s, e in union(clip(intervals, lo, hi)))


def idle_share(intervals, lo, hi) -> float:
    """1 − busy / (hi − lo): the share of the window in which no operation ran."""
    return 1.0 - busy(intervals, lo, hi) / (hi - lo)


def gaps(intervals, lo, hi):
    """The idle intervals of [lo, hi]."""
    out, t = [], lo
    for s, e in union(clip(intervals, lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def label(gap, spans) -> str:
    """The host span that overlaps the gap most (the shorter on a tie), or
    "no span"."""
    best, key = "no span", (0, 0)
    for name, s, e in spans:
        ov = min(e, gap[1]) - max(s, gap[0])
        if ov > 0 and (ov, -(e - s)) > key:
            best, key = name, (ov, -(e - s))
    return best


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile of all the values."""
    v = sorted(values)
    k = max(0, min(len(v) - 1, -(-len(v) * q // 100) - 1))
    return v[int(k)]


@dataclass
class Trace:
    """A profiled sub-window, times in seconds on the profiler's clock."""

    window: tuple
    ops: list        # (name, start, end) of every device operation
    spans: list      # (name, start, end) of the benchmark's own spans

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def kernels(self):
        return [o for o in self.ops if not o[0].startswith(NOT_KERNELS)]

    def busy_s(self) -> float:
        return busy([(s, e) for _, s, e in self.ops], *self.window)

    def idle_share(self) -> float:
        return idle_share([(s, e) for _, s, e in self.ops], *self.window)

    def kernel_time(self, substring: str = ""):
        """(records, summed seconds) of the kernels whose name holds
        ``substring``."""
        ks = [e - s for n, s, e in self.kernels if substring in n]
        return len(ks), sum(ks)

    def top_ops(self, n: int = 10):
        tot = {}
        for name, s, e in self.ops:
            tot[name] = tot.get(name, 0.0) + (e - s)
        return sorted(tot.items(), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10):
        gs = sorted(gaps([(s, e) for _, s, e in self.ops], *self.window),
                    key=lambda g: g[0] - g[1])[:n]
        return [(label(g, self.spans), g[1] - g[0]) for g in gs]

    def edges(self):
        """(first operation's start − window start, window end − last
        operation's end), seconds: both ≥ 0 where the clocks agree."""
        return (min(s for _, s, _ in self.ops) - self.window[0],
                self.window[1] - max(e for _, _, e in self.ops))


@dataclass
class Tracer:
    """Spans of a run (wall clock, ns), kept in memory when ``on``, and the
    profiled sub-window's trace once :meth:`profiled` has closed."""

    on: bool = False
    spans: list = field(default_factory=list)
    trace: Trace = None
    _profiling: bool = False

    @property
    def profiling(self) -> bool:
        return self._profiling

    def add(self, name: str, t0: int, t1: int) -> None:
        if self.on:
            self.spans.append((name, t0, t1))

    @contextlib.contextmanager
    def profiled(self, sync):
        """Profile the device through the body, the sub-window, between two
        ``sync()`` calls. Only device activity is recorded (recording the
        host's operators too would slow the host path that the window
        measures); the spans recorded meanwhile, on the same wall clock as
        the profiler's records, label the trace."""
        from torch.profiler import ProfilerActivity, profile

        sync()
        first = len(self.spans)
        with warnings.catch_warnings():
            # "Profiler clears events at the end of each cycle": one cycle here
            warnings.filterwarnings("ignore", message=".*Profiler clears events")
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                self._profiling = True
                try:
                    t0 = now_ns()
                    yield
                    sync()
                    t1 = now_ns()
                finally:
                    self._profiling = False
        self.trace = from_profile(prof, (t0, t1), self.spans[first:])

    def write(self, path) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            for name, t0, t1 in self.spans:
                f.write(json.dumps({"span": name, "start_ns": t0, "end_ns": t1}) + "\n")


def from_profile(prof, window_ns, spans_ns) -> Trace:
    """The sub-window's device operations, with the host's spans, in seconds."""
    from torch.autograd import DeviceType

    ops = [(e.name(), e.start_ns() / 1e9, (e.start_ns() + e.duration_ns()) / 1e9)
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0]
    return Trace((window_ns[0] / 1e9, window_ns[1] / 1e9), ops,
                 [(n, a / 1e9, b / 1e9) for n, a, b in spans_ns])


def now_ns() -> int:
    """Wall-clock ns: the profiler's records are on this clock."""
    return time.time_ns()
