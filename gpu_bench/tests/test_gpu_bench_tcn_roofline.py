"""K9's cost (``costs/tcn.py``) against hand counts, and its roofline
reader (``metrics/tcn_block_roofline.py``) on a hand-built Chrome trace."""
from types import SimpleNamespace

import pytest

from gpu_bench.costs import kernels, tcn
from gpu_bench.metrics import tcn_block_roofline as reader
from gpu_bench.trace import Trace

# the embedding cell's second block: x [8, 15, 256, 256, 64] series-major,
# no projection, no head
BLOCK_1 = [(8, 15, 256, 256, 64), (64, 64, 3), (64,), (64,), (64,),
           (64, 64, 1), (64,), (), (), (), (), (), (), (), (), ()]


@pytest.mark.parametrize("t,d,want", [(15, 1, 43), (15, 2, 41),
                                      (15, 4, 37), (5, 4, 7), (2, 2, 2),
                                      (1, 1, 1)])
def test_taps_inside_the_series(t, d, want):
    """Counted one (step, tap) pair at a time."""
    assert tcn.taps_inside(t, d) == want == sum(
        0 <= s + (k - 1) * d < t for s in range(t) for k in range(3))


def test_a_blocks_cost_by_hand():
    n, t, cin, z = 3, 5, 13, 8
    dims = [(n, t, cin), (64, cin, 3), (64,), (64,), (64,), (64, 64, 1),
            (64,), (64, cin, 1), (64,), (z, 64), (z,), (n, z), (n, z)]
    taps = tcn.taps_inside(t, 2)
    flops = 2 * n * (taps * cin * 64 + t * (64 * 64 + cin * 64 + z * 64))
    weights = (64 * cin * 3 + 64 * 3 + 64 * 64 + 64 + 64 * cin + 64
               + z * 64 + z)
    moved = n * t * (cin + z) + weights + 2 * n * z
    assert tcn.tcn_block(dims, 2) == kernels.Cost(flops, 4 * moved)
    # without its dilation, the fewest taps of the kernel's dilations
    assert tcn.tcn_block(dims).flops == tcn.tcn_block(dims, 4).flops


def trace_of(calls):
    """A window of one unit, each call (dims, concrete inputs or None,
    kernel us) an op event with its kernel."""
    events = [{"ph": "X", "cat": "user_annotation", "name": "unit",
               "ts": 0, "dur": 10_000, "tid": 1, "args": {}}]
    for i, (dims, concrete, us) in enumerate(calls):
        args = {"External id": 100 + i, "Input Dims": [list(d) for d in dims],
                "Input type": ["float"] + [""] * (len(dims) - 1)}
        if concrete is not None:
            args["Concrete Inputs"] = concrete
        events.append({"ph": "X", "cat": "cpu_op", "name":
                       "forest_tpu_torch::tcn_block", "ts": 10 + 100 * i,
                       "dur": 50, "tid": 1, "args": args})
        events.append({"ph": "X", "cat": "kernel", "name": "tcn_block_kernel",
                       "ts": 20 + 100 * i, "dur": us, "tid": 7,
                       "args": {"External id": 100 + i}})
    return Trace(events)


def test_the_reader_takes_each_calls_dilation():
    concrete = [""] * 13 + ["2", "8", "1e-05"]
    run = SimpleNamespace(trace=trace_of([(BLOCK_1, concrete, 9000.0)]))
    least = kernels.bound_s(tcn.tcn_block(BLOCK_1, 2))
    assert reader.read(run) == pytest.approx(100 * least / 9e-3)
    # a trace without concrete inputs: the dilation with the fewest taps
    run = SimpleNamespace(trace=trace_of([(BLOCK_1, None, 9000.0)]))
    least = kernels.bound_s(tcn.tcn_block(BLOCK_1, 4))
    assert reader.read(run) == pytest.approx(100 * least / 9e-3)


def test_the_reader_finds_nothing_where_nothing_ran():
    assert reader.read(SimpleNamespace(trace=None)) is None
    assert reader.read(SimpleNamespace(trace=trace_of([]))) is None
