"""The span readers on a hand-built Chrome trace, and the program's spans
in a traced run of each cell on the CPU."""
import pytest

from gpu_bench import harness, spans
from gpu_bench.span_table import traced_cell
from gpu_bench.trace import Trace

from small import bench, workload


def span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "tid": tid, "args": {}}


def launch(ts, corr, tid=1, name="cudaLaunchKernel"):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts,
            "dur": 1, "tid": tid, "args": {"correlation": corr}}


def device(ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": f"k{corr}", "ts": ts, "dur": dur,
            "tid": 7, "args": {"correlation": corr}}


def step_trace(with_spans=True):
    """Two units of 100 us: forward [0, 40) with a nested type encoder and
    a data.features nested in another, backward [40, 80) whose kernel is
    launched from a second thread, update [80, 95) with a sync."""
    ev = []
    for u in range(2):
        o = 100 * u
        ev += [span("unit", o, 100)]
        if with_spans:
            ev += [span("step.forward", o, 40),
                   span("data.features", o + 1, 9),
                   span("data.features", o + 2, 5),
                   span("model.type_encoder", o + 10, 20),
                   span("step.backward", o + 40, 40),
                   span("step.update", o + 80, 15)]
        c = 10 * u
        ev += [launch(o + 3, c + 1), device(o + 5, 4, c + 1),
               launch(o + 12, c + 2), device(o + 14, 10, c + 2,
                                             "gpu_memcpy"),
               launch(o + 45, c + 3, tid=2), device(o + 50, 20, c + 3),
               launch(o + 85, c + 4), device(o + 86, 2, c + 4, "gpu_memset"),
               launch(o + 89, c + 5, name="cudaStreamSynchronize")]
    ev.append(span("finish", 200, 1))
    return Trace(ev)


def test_device_time_of_a_span():
    tr = step_trace()
    assert spans.device_ms(tr, "step.forward") == pytest.approx(0.014)
    assert spans.device_ms(tr, "model.type_encoder") == pytest.approx(0.010)
    assert spans.device_ms(tr, "step.update") == pytest.approx(0.002)


def test_a_kernel_launched_from_another_thread_counts():
    assert spans.device_ms(step_trace(), "step.backward") == \
        pytest.approx(0.020)


def test_nested_spans_are_not_counted_twice():
    tr = step_trace()
    assert spans.intervals(tr, "data.features") == [(1, 10), (101, 110)]
    assert spans.device_ms(tr, "data.features") == pytest.approx(0.004)


def test_idle_time_of_a_span():
    tr = step_trace()
    # forward: 40 us of host time, the device busy 5-9 and 14-24
    assert spans.idle_ms(tr, "step.forward") == pytest.approx(0.026)
    assert spans.idle_ms(tr, "step.backward") == pytest.approx(0.020)
    assert spans.idle_ms(tr, "step.update") == pytest.approx(0.013)


def test_a_trace_without_the_spans_reads_none():
    tr = step_trace(with_spans=False)
    for name in ("step.forward", "data.features"):
        assert spans.device_ms(tr, name) is None
        assert spans.idle_ms(tr, name) is None
    assert spans.device_ms(None, "step.forward") is None
    for m in bench()["per_layer"]:
        if m["source"] == "program_span":
            assert harness.reader(m["name"]).read(
                type("Run", (), {"trace": tr})) is None, m["name"]


def test_table_counts_launches_and_syncs():
    t = spans.table(step_trace())
    assert set(t) == {"unit", "step.forward", "step.backward", "step.update",
                      "data.features", "model.type_encoder"}
    assert t["unit"]["launches"] == 4 and t["unit"]["syncs"] == 1
    assert t["step.forward"]["launches"] == 2
    assert t["step.update"]["syncs"] == 1 and t["step.forward"]["syncs"] == 0
    assert t["unit"]["device_ms"] == pytest.approx(0.036)


CELLS = ["frl_v1.train_b12", "frl_v1.embed_b8"]
#: the spans whose device time makes up a unit's, by cell
STAGES = {"frl_v1.train_b12": ("step.forward", "step.backward",
                               "step.update"),
          "frl_v1.embed_b8": ("data.features", "model.type_encoder",
                              "model.phase_encoder")}


def _traced_small(cell, device):
    """The operator stretch's trace of one unit of the cell's small
    form."""
    return traced_cell(cell, 3, device, workload(cell), units=1)[1]


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_holds_the_programs_spans(cell):
    """The operator stretch of a small CPU run holds the spans the cell's
    metrics read, nested as the program nests them."""
    import torch
    tr = _traced_small(cell, torch.device("cpu"))
    assert {"unit", "data.features", "model.type_encoder",
            "model.phase_encoder", *STAGES[cell]} <= set(spans.table(tr))
    inner = spans.intervals(tr, "model.type_encoder")
    outer = spans.intervals(tr, STAGES[cell][0] if cell.endswith("b12")
                            else "unit")
    assert inner and all(any(a <= x and y <= b for a, b in outer)
                         for x, y in inner)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_stages_hold_a_units_device_time(cell, cuda_device):
    """On the card each stage launches device work, the backward's from
    autograd's thread among it, and the stages hold nearly all of it."""
    tr = _traced_small(cell, cuda_device)
    unit = spans.device_ms(tr, "unit")
    parts = [spans.device_ms(tr, s) for s in STAGES[cell]]
    assert unit > 0 and all(p > 0 for p in parts), parts
    assert sum(parts) >= 0.95 * unit, (parts, unit)
