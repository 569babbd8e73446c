"""Shared arithmetic of the per-layer readers in bench_port/metrics.

Each reader takes the traced run (`run.Traced`: the renderer kind, the
number of traced frames, the device trace, the probes' captured launches,
the program's spans and counters with the stage table that joins them to
the trace, and the set-up's upload seconds) and returns a number, or
None where the run holds nothing for it to read.
"""

from __future__ import annotations

from . import roofline, stages

# PyTorch's gather and indexing kernels (advanced indexing, take,
# index_select, gather): in these renderers mostly shading's texel and
# table-row fetches
GATHER_PARTS = ("gather", "index", "Index", "Gather")

KERNELS = {
    "k1": (("intersect_bruteforce_kernel",), roofline.k1_work),
    "k2": (("matrix_walk_kernel",), roofline.k2_work),
    "k3": (("order_tiles_kernel", "raster_tiled_kernel"), roofline.k3_work),
}


def span_busy_ms(run, *names):
    """Device ms a traced frame charged to the spans `names` as the
    innermost span open at each operation's launch (`lib/stages.py`);
    None where no span of theirs was recorded or nothing ran under them."""
    ms = stages.busy_ms(run.stages, names)
    return ms if ms else None


def counter_per_frame(run, name: str):
    """The program's counter `name`, summed over its labels, per traced
    frame; None where it was never counted."""
    if not any(c["name"] == name for c in run.counters):
        return None
    return stages.counter_total(run.counters, name) / run.stage_frames


def launches_per_frame(run, kind: str):
    if run.kind != kind or run.trace.count() == 0:
        return None
    return run.trace.count() / run.frames


def gather_ms(run, kind: str):
    if run.kind != kind:
        return None
    ms = run.trace.time_s(GATHER_PARTS) * 1e3 / run.frames
    return ms if ms > 0 else None


def idle_share(run, kind: str):
    """100 x (1 - the device's busy time a traced frame / the unprofiled
    window's mean frame). The busy time is the union of the device
    intervals of the frames traced with device activity alone (kernel
    times the profiler barely moves); the frame time is not taken from
    the traced frames, which the profiler's host overhead lengthens."""
    if run.kind != kind or run.trace.window_s() <= 0 or not run.trace.dev_ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.frames / run.mean_frame_s)


def roofline_share(run, kernel: str):
    """100 x the sum of the captured launches' bounds over the sum of
    their device times (the first captured launches, matched in launch
    order to the kernel's device operations; a launch of K3 is its two
    kernels). None where the traced frames launched the kernel not at
    all; a run whose traced kernels do not match the launches the probes
    counted raises, since the share would be of other work."""
    names, work = KERNELS[kernel]
    launches = run.captured[kernel]
    calls = run.captured["calls"][kernel]
    ops = [e for e in run.trace.dev_ops if any(n in e.name for n in names)]
    if not launches and not ops:
        return None
    per_launch = len(names)
    if len(ops) != calls * per_launch:
        raise RuntimeError(
            f"{kernel}: {calls} launches captured but {len(ops)} device operations named "
            f"{' or '.join(names)} traced (expected {per_launch} each); the probes or the "
            f"kernel names no longer match the program")
    ops = ops[:len(launches) * per_launch]
    spent_ms = sum(e.end - e.start for e in ops) / 1e6
    bound = sum(work(launch)[0] for launch in launches)
    return 100.0 * bound / spent_ms
