"""Reading a torch.profiler trace of the card.

`DeviceTrace.from_profile` keeps, from the profiler's raw events, every
operation that ran on the device (kernels, copies, fills) with its start
and end, and every host operation with its thread, start and end. From
them: the busy time (the union of the device intervals), the device
operations that took most time, the idle gaps between device operations
named by what the host was doing (the host operation that launched the
operation that ends the gap, under the benchmark's own span).

A run on the CPU (`cpu_device`, tests only: the benchmark refuses to run
without a card) has no device row; there the device is the CPU, and the
outermost PyTorch operations of each thread stand for the device
operations, each launched at its own start.
"""

from __future__ import annotations

import bisect
import dataclasses


@dataclasses.dataclass
class DevOp:
    name: str
    start: int   # ns
    end: int
    corr: tuple  # the event's correlation ids, own and linked


@dataclasses.dataclass
class HostOp:
    name: str
    start: int
    end: int
    thread: int
    annotation: bool


_RUNTIME_PREFIXES = ("cuda", "cu", "Memcpy", "Memset")


def _outermost(ops, launches):
    """The operations that no earlier operation of the same thread
    contains."""
    out, open_until = [], {}
    for e in sorted(ops, key=lambda e: (e.start, -e.end)):
        thread = launches[e.corr[0]][1]
        if e.end <= open_until.get(thread, -1):
            continue
        open_until[thread] = e.end
        out.append(e)
    return out


class DeviceTrace:
    def __init__(self, dev_ops, host_ops, launches, t0: int, t1: int):
        self.dev_ops = sorted(dev_ops, key=lambda e: e.start)
        self.host_ops = host_ops
        self.launches = launches  # correlation id -> (start ns, thread)
        self.t0, self.t1 = t0, t1

    @staticmethod
    def from_profile(prof, t0_ns: int | None = None, t1_ns: int | None = None,
                     cpu_device: bool = False):
        dev, host, launches = [], [], {}
        for e in prof.profiler.kineto_results.events():
            kind = str(e.device_type())
            start, dur = int(e.start_ns()), int(e.duration_ns())
            name = e.name()
            if kind.endswith("CUDA"):
                if e.is_user_annotation() or name.startswith("bench."):
                    continue  # the benchmark's own spans, drawn on the device row
                corr = (int(e.correlation_id()), int(e.linked_correlation_id()))
                dev.append(DevOp(name, start, start + dur, corr))
            else:
                if name.startswith(("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset")):
                    for c in (int(e.correlation_id()), int(e.linked_correlation_id())):
                        if c:
                            launches.setdefault(c, (start, int(e.start_thread_id())))
                if name.startswith(_RUNTIME_PREFIXES) and not name.startswith("aten"):
                    continue
                host.append(HostOp(name, start, start + dur, int(e.start_thread_id()),
                                   bool(e.is_user_annotation())))
                if cpu_device and name.startswith("aten::"):
                    corr = int(e.correlation_id())
                    dev.append(DevOp(name, start, start + dur, (corr, 0)))
                    launches[corr] = (start, int(e.start_thread_id()))
        if cpu_device:
            dev = _outermost(dev, launches)
        if dev:
            t0 = t0_ns if t0_ns is not None else min(e.start for e in dev)
            t1 = t1_ns if t1_ns is not None else max(e.end for e in dev)
        else:
            t0, t1 = t0_ns or 0, t1_ns or 0
        return DeviceTrace(dev, host, launches, t0, t1)

    # -- totals ---------------------------------------------------------

    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def intervals(self):
        """The union of the device intervals inside the window."""
        out = []
        for e in self.dev_ops:
            s, t = max(e.start, self.t0), min(e.end, self.t1)
            if t <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return out

    def busy_s(self) -> float:
        return sum(t - s for s, t in self.intervals()) / 1e9

    def time_s(self, parts) -> float:
        return sum(e.end - e.start for e in self.dev_ops
                   if any(p in e.name for p in parts)) / 1e9

    def count(self) -> int:
        """Device operations that are kernels (copies and fills left out)."""
        return sum(1 for e in self.dev_ops if not e.name.startswith(("Memcpy", "Memset")))

    # -- the breakdown ------------------------------------------------------

    def top_ops(self, k: int = 10):
        total = {}
        for e in self.dev_ops:
            key = e.name[:120]
            total[key] = total.get(key, 0) + (e.end - e.start)
        rows = sorted(total.items(), key=lambda kv: -kv[1])[:k]
        return [[name, ns / 1e9] for name, ns in rows]

    def _host_at(self, t: int, thread: int) -> str:
        """The innermost host operation and the outermost annotation of
        the benchmark running at time t on `thread`."""
        inner, outer = None, None
        for h in self.host_ops:
            if h.thread != thread or not (h.start <= t <= h.end):
                continue
            if h.annotation and h.name.startswith("bench."):
                if outer is None or h.start < outer.start:
                    outer = h
            elif not h.annotation:
                if inner is None or h.start >= inner.start:
                    inner = h
        parts = [p.name for p in (outer, inner) if p is not None]
        return " > ".join(parts) if parts else "host"

    def idle_gaps(self, k: int = 10):
        """The k longest gaps between device intervals, each named by
        the host operation that launched the device operation ending it."""
        iv = self.intervals()
        starts = [e.start for e in self.dev_ops]
        gaps = []
        for (_, a_end), (b_start, _) in zip(iv, iv[1:]):
            gaps.append((b_start - a_end, b_start))
        gaps.sort(reverse=True)
        out = []
        for length, b_start in gaps[:k]:
            i = bisect.bisect_left(starts, b_start)
            name = "host"
            if i < len(self.dev_ops):
                launch = next((self.launches[c] for c in self.dev_ops[i].corr
                               if c and c in self.launches), None)
                if launch is not None:
                    name = self._host_at(launch[0], launch[1])
                name = f"{name} -> {self.dev_ops[i].name[:60]}"
            out.append([name, length / 1e9])
        return out
