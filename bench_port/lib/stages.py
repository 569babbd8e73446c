"""Which stage of the program each device operation and idle gap belongs to.

The program's tracer (`hala_tpu_torch/utils/profiling.py`) records
spans on `time.time_ns()`, the clock of torch.profiler's kineto events.
`attribute(trace, spans, frames)` joins the two:

- each device operation of a `devtrace.DeviceTrace` is matched to its
  runtime launch event by correlation id (as `DeviceTrace.launches`
  holds them) and charged to the innermost span open at that launch;
- an operation without a launch event is charged to the stage of the
  operation before it on the stream (the program launches on one
  stream, in order), and counted in `inherited`;
- each idle gap between device intervals is charged to the stage of
  the operation that ends it;
- device time under no span is charged to `unattributed`.

Spans are taken as one thread's, properly nested (the program records
its frames on the thread that calls `update()`); the spans inside the
trace's window take part. The table gives, per span name and per traced
frame: the spans' count, their host ms inclusive and self (less their
children), the device ms and idle ms charged to them as innermost span,
and the kernels launched under them (copies and fills left out, as
`DeviceTrace.count`); and per stage its device operations by name,
longest first.
"""

from __future__ import annotations

import bisect

UNATTRIBUTED = "unattributed"


def _field(s, key):
    return s[key] if isinstance(s, dict) else getattr(s, key)


def _innermost(spans):
    """The step function of the innermost open span: (times, names),
    where names[i] holds from times[i] until times[i + 1] (None where no
    span is open)."""
    order = sorted(spans, key=lambda s: (s["start"], -s["end"]))
    times, names, stack = [], [], []

    def mark(t, name):
        if times and times[-1] == t:
            names[-1] = name
        else:
            times.append(t)
            names.append(name)

    def close_until(t):
        while stack and stack[-1]["end"] <= t:
            done = stack.pop()
            mark(done["end"], stack[-1]["name"] if stack else None)

    for s in order:
        close_until(s["start"])
        stack.append(s)
        mark(s["start"], s["name"])
    close_until(float("inf"))
    return times, names


def _stage_at(step, t):
    times, names = step
    i = bisect.bisect_right(times, t) - 1
    return names[i] if i >= 0 else None


def attribute(trace, spans, frames: int) -> dict:
    """The stage table of `trace` (a DeviceTrace) under `spans`, per
    traced frame. Returns {"stages": {name: row}, "kernels": {stage:
    {operation: device ms}}, "inherited": n, "ops": n,
    "unattributed_share": % of device busy time}."""
    spans = [dict(name=_field(s, "name"), start=_field(s, "start"), end=_field(s, "end"),
                  index=_field(s, "index"), parent=_field(s, "parent")) for s in spans]
    spans = [s for s in spans if s["end"] >= trace.t0 and s["start"] <= trace.t1]
    step = _innermost(spans)
    rows = {}

    def row(name):
        return rows.setdefault(name, dict(count=0, host_ms=0.0, self_ms=0.0, busy_ms=0.0,
                                          idle_ms=0.0, launches=0))

    child_ns = {}
    for s in spans:
        child_ns[s["parent"]] = child_ns.get(s["parent"], 0) + (s["end"] - s["start"])
    for s in spans:
        r = row(s["name"])
        r["count"] += 1
        r["host_ms"] += (s["end"] - s["start"]) / 1e6
        r["self_ms"] += (s["end"] - s["start"] - child_ns.get(s["index"], 0)) / 1e6

    ops = trace.dev_ops  # sorted by start
    kernels = {}
    stage_of, inherited, prev = [], 0, UNATTRIBUTED
    for e in ops:
        launch = next((trace.launches[c] for c in e.corr if c and c in trace.launches), None)
        if launch is None:
            inherited += 1
            stage = prev
        else:
            stage = _stage_at(step, launch[0]) or UNATTRIBUTED
        stage_of.append(stage)
        prev = stage
        s, t = max(e.start, trace.t0), min(e.end, trace.t1)
        r = row(stage)
        if t > s:
            r["busy_ms"] += (t - s) / 1e6
            by_name = kernels.setdefault(stage, {})
            by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + (t - s) / 1e6 / frames
        if not e.name.startswith(("Memcpy", "Memset")):
            r["launches"] += 1

    starts = [e.start for e in ops]
    iv = trace.intervals()
    for (_, a_end), (b_start, _) in zip(iv, iv[1:]):
        i = bisect.bisect_left(starts, b_start)
        stage = stage_of[i] if i < len(ops) else UNATTRIBUTED
        row(stage)["idle_ms"] += (b_start - a_end) / 1e6

    busy = sum(r["busy_ms"] for r in rows.values())
    lost = rows.get(UNATTRIBUTED, {}).get("busy_ms", 0.0)
    per_frame = {name: {k: v / frames for k, v in r.items()} for name, r in rows.items()}
    top = {stage: dict(sorted(by_name.items(), key=lambda kv: -kv[1]))
           for stage, by_name in kernels.items()}
    return {"stages": per_frame, "kernels": top, "inherited": inherited, "ops": len(ops),
            "unattributed_share": 100.0 * lost / busy if busy > 0 else 0.0}


def busy_ms(table: dict, names) -> float | None:
    """Device ms a traced frame charged to the stages `names`; None
    where no span of theirs was recorded."""
    rows = [table["stages"][n] for n in names if n in table["stages"]]
    return sum(r["busy_ms"] for r in rows) if rows else None


def host_ms(table: dict, name: str) -> float | None:
    """Host ms a traced frame inside the spans `name`."""
    row = table["stages"].get(name)
    return row["host_ms"] if row else None


def counter_total(counters, name: str) -> int:
    """The sum of the counter `name` over its labels."""
    return sum(c["value"] for c in counters if c["name"] == name)
