"""Probes on the program's kernel launches, for the roofline readers.

`capture()` wraps, for its duration, the three module-level launch
functions of the visibility kernels (K1's, K2's and K3's, each called
once per launch) and keeps references to each launch's inputs and
answers. It adds no device work: nothing is copied or reduced while the
profiler runs. Every call is counted; the inputs of the first
`KEEP[kernel]` calls are kept.
"""

from __future__ import annotations

import contextlib

KEEP = {"k1": 1 << 30, "k2": 3, "k3": 1 << 30}


@contextlib.contextmanager
def capture():
    from hala_tpu_torch.ops import raster_kernel, traverse
    from hala_tpu_torch.ops.pallas import intersect_kernel

    captured = {"k1": [], "k2": [], "k3": [], "calls": {"k1": 0, "k2": 0, "k3": 0}}

    def keep(kind, entry):
        captured["calls"][kind] += 1
        if len(captured[kind]) < KEEP[kind]:
            captured[kind].append(entry)

    k1_launch = intersect_kernel._launch
    k2_launch = traverse._launch_matrix
    k3_launch = raster_kernel._launch

    def k1(o, d, tri_v0, tri_e1, tri_e2, tm, num_real, any_hit):
        hit = k1_launch(o, d, tri_v0, tri_e1, tri_e2, tm, num_real, any_hit)
        keep("k1", dict(tm=tm, num_real=num_real, any_hit=any_hit))
        return hit

    def k2(o, d, tm, cmin, cmax, tri_packed, any_hit, with_runs=False):
        res = k2_launch(o, d, tm, cmin, cmax, tri_packed, any_hit, with_runs)
        hit = res[0] if with_runs else res
        keep("k2", dict(o=o, d=d, tm=tm, cmin=cmin, cmax=cmax, tri_packed=tri_packed,
                        any_hit=any_hit, t=hit.t, tri=hit.tri))
        return res

    def k3(starts, data, tw, tile):
        planes = k3_launch(starts, data, tw, tile)
        keep("k3", dict(starts=starts, data=data, tw=tw, tile=tile))
        return planes

    intersect_kernel._launch = k1
    traverse._launch_matrix = k2
    raster_kernel._launch = k3
    try:
        yield captured
    finally:
        intersect_kernel._launch = k1_launch
        traverse._launch_matrix = k2_launch
        raster_kernel._launch = k3_launch
