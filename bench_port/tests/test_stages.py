"""The attribution of `lib/stages.py` on a synthetic device trace and
spans: each operation charged to the innermost span open at its launch,
an idle gap to the stage of the operation that ends it, an operation
without a launch event to the stage of the one before it, and device
time under no span to `unattributed`.

    python3 -m pytest -q bench_port/tests
"""

from __future__ import annotations

import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from lib import stages  # noqa: E402
from lib.devtrace import DeviceTrace, DevOp  # noqa: E402


def _span(index, name, start, end, parent=-1):
    return dict(index=index, name=name, start=start, end=end, parent=parent)


# ns; one frame from 0 to 1000: query [100, 400] holds sort [120, 180],
# shade [500, 700], and nothing open from 700 to 800
SPANS = [
    _span(0, "hala.frame", 0, 800),
    _span(1, "hala.query", 100, 400, 0),
    _span(2, "hala.sort", 120, 180, 1),
    _span(3, "hala.shade", 500, 700, 0),
]


def _trace(ops, launches):
    dev = [DevOp(name, s, e, (corr, 0)) for name, s, e, corr in ops]
    return DeviceTrace(dev, [], launches, 0, 2000)


def test_innermost_span_at_launch():
    trace = _trace([("sort_kernel", 200, 250, 1), ("matrix_walk_kernel", 260, 360, 2),
                    ("gather", 600, 640, 3), ("glue", 650, 660, 4)],
                   {1: (150, 1), 2: (190, 1), 3: (550, 1), 4: (50, 1)})
    table = stages.attribute(trace, SPANS, frames=1)["stages"]
    assert table["hala.sort"]["busy_ms"] == pytest.approx(50e-6)
    assert table["hala.query"]["busy_ms"] == pytest.approx(100e-6)
    assert table["hala.shade"]["busy_ms"] == pytest.approx(40e-6)
    assert table["hala.frame"]["busy_ms"] == pytest.approx(10e-6)
    assert table["hala.query"]["launches"] == 1
    # host time: inclusive and less the children
    assert table["hala.query"]["host_ms"] == pytest.approx(300e-6)
    assert table["hala.query"]["self_ms"] == pytest.approx(240e-6)
    assert table["hala.frame"]["self_ms"] == pytest.approx((800 - 300 - 200) * 1e-6)


def test_idle_gap_charged_to_the_op_that_ends_it():
    trace = _trace([("a", 200, 250, 1), ("b", 300, 320, 2), ("c", 600, 610, 3)],
                   {1: (150, 1), 2: (190, 1), 3: (550, 1)})
    table = stages.attribute(trace, SPANS, frames=1)["stages"]
    assert table["hala.query"]["idle_ms"] == pytest.approx(50e-6)   # 250 -> 300
    assert table["hala.shade"]["idle_ms"] == pytest.approx(280e-6)  # 320 -> 600
    assert table["hala.sort"]["idle_ms"] == 0.0


def test_op_without_launch_inherits_the_previous_stage():
    trace = _trace([("a", 200, 250, 1), ("Memcpy DtoD", 250, 270, 9), ("b", 600, 610, 3)],
                   {1: (150, 1), 3: (550, 1)})
    out = stages.attribute(trace, SPANS, frames=1)
    assert out["inherited"] == 1
    assert out["stages"]["hala.sort"]["busy_ms"] == pytest.approx(70e-6)
    # copies and fills are not kernel launches
    assert out["stages"]["hala.sort"]["launches"] == 1


def test_device_time_under_no_span_is_unattributed():
    trace = _trace([("a", 200, 250, 1), ("b", 900, 960, 2), ("c", 970, 980, 5)],
                   {1: (150, 1), 2: (850, 1)})
    out = stages.attribute(trace, SPANS, frames=2)
    lost = out["stages"][stages.UNATTRIBUTED]
    # b launched after the frame closed, c inherits b's stage; per frame
    assert lost["busy_ms"] == pytest.approx(70e-6 / 2)
    assert out["unattributed_share"] == pytest.approx(100.0 * 70 / 120)
    assert stages.busy_ms(out, ["hala.sort"]) == pytest.approx(50e-6 / 2)
    assert stages.busy_ms(out, ["hala.raygen"]) is None
    assert stages.host_ms(out, "hala.frame") == pytest.approx(800e-6 / 2)


def test_spans_outside_the_window_take_no_part():
    late = SPANS + [_span(4, "hala.frame", 5000, 6000)]
    trace = _trace([("a", 200, 250, 1)], {1: (150, 1)})
    assert stages.attribute(trace, late, frames=1)["stages"]["hala.frame"]["count"] == 1
    assert stages.counter_total([{"name": "query.rays", "labels": {"kind": "any"}, "value": 3},
                                 {"name": "query.rays", "labels": {"kind": "extend"}, "value": 4},
                                 {"name": "query.calls", "labels": {}, "value": 2}],
                                "query.rays") == 7


def test_kernels_listed_under_their_stage():
    trace = _trace([("k2", 200, 250, 1), ("k2", 260, 300, 2), ("gather", 600, 610, 3)],
                   {1: (150, 1), 2: (190, 1), 3: (550, 1)})
    kernels = stages.attribute(trace, SPANS, frames=2)["kernels"]
    assert kernels["hala.sort"] == {"k2": pytest.approx(50e-6 / 2)}
    assert kernels["hala.query"] == {"k2": pytest.approx(40e-6 / 2)}
    assert kernels["hala.shade"] == {"gather": pytest.approx(10e-6 / 2)}
