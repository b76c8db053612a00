"""The port's spans (``forest_tpu_torch/utils/spans.py``) in the profiler's
own trace, on the CPU at the parity tests' small sizes:

- one FRL train step under ``torch.profiler``: every stage's span, nested
  as the step nests them (the feature builds and both encoders inside
  ``step.forward``; backward and update after it, inside no other stage);
  a step that raises still closes the spans it was in;
- with no profiler running, ``span()`` is one shared no-op context;
- ``--profile``'s ``maybe_trace`` around a two-batch ``run_epoch``: the
  loop's, the loader's and the step's spans in ``trace.json``, the loader
  workers' among them.
"""
import contextlib
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from forest_tpu_torch.utils import spans

from torch_parity import TINY_B, TINY_HW, TINY_MODEL, TINY_T

CURRICULUM = {"input_dropout_rate": 0.05, "min_gate": 0.0}


def _tiny():
    """The port's FRL train step over the synthetic bindings and the tiny
    model: (state, train_step, model, a batch maker)."""
    from forest_tpu_torch.data import (parse_bindings, synthetic_bindings,
                                       synthetic_feature_stats,
                                       synthetic_frl_batch)
    from forest_tpu_torch.data.feature_builder import FeatureBuilder
    from forest_tpu_torch.models import representation as rep
    from forest_tpu_torch.training.representation import (
        config_builders as cb, step as step_mod, train_step as ts)
    bindings = parse_bindings(synthetic_bindings("unused.zarr",
                                                 "unused.json"))
    fb = FeatureBuilder(bindings, synthetic_feature_stats(bindings))
    model = rep.RepresentationModel(**TINY_MODEL)
    rep.init_parameters(model, torch.Generator().manual_seed(0))
    process = step_mod.make_process_batch(
        model, fb, cb.build_sampler(bindings, {}),
        cb.build_step_config(bindings, {}), TINY_HW, device="cpu")
    opt = ts.make_optimizer(1e-4)

    def batch(seed, b=TINY_B):
        return synthetic_frl_batch(np.random.default_rng(seed), b, TINY_HW,
                                   TINY_T)
    return (ts.init_train_state(model, opt), ts.make_train_step(process, opt),
            model, batch, dict(step_mod.DEFAULT_WEIGHTS))


def _ranges(events, name):
    return [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"] == name]


def _within(inner, outer):
    return all(any(a <= x and y <= b for a, b in outer) for x, y in inner)


def _traced(fn, tmp_path):
    """Runs ``fn`` under the profiler (host only) -> the Chrome trace's
    events, and what ``fn`` raised (or None)."""
    err = None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        try:
            fn()
        except RuntimeError as e:
            err = e
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"], err


def test_a_train_step_has_every_span_nested(tmp_path):
    state, step, _, batch, weights = _tiny()
    b = {k: torch.as_tensor(v) for k, v in batch(0).items()}
    gen = torch.Generator().manual_seed(0)
    events, err = _traced(lambda: step(state, b, gen, weights, CURRICULUM),
                          tmp_path)
    assert err is None
    r = {n: _ranges(events, n) for n in (
        "step.forward", "step.backward", "step.update", "data.features",
        "model.type_encoder", "model.phase_encoder", "step.allreduce")}
    assert len(r["step.forward"]) == len(r["step.backward"]) == \
        len(r["step.update"]) == 1
    assert r["step.allreduce"] == []            # one process: no group
    assert len(r["model.type_encoder"]) == len(r["model.phase_encoder"]) == 1
    assert len(r["data.features"]) >= 3         # type, spectral, phase
    fwd, bwd, upd = (r[f"step.{s}"][0] for s in
                     ("forward", "backward", "update"))
    for inner in ("data.features", "model.type_encoder",
                  "model.phase_encoder"):
        assert _within(r[inner], [fwd]), inner
    assert fwd[1] <= bwd[0] and bwd[1] <= upd[0]
    # the feature builds and the encoders do not overlap one another
    enc = r["model.type_encoder"] + r["model.phase_encoder"]
    assert not [f for f in r["data.features"] if _within([f], enc)]


def test_a_step_that_raises_closes_its_spans(tmp_path, monkeypatch):
    state, step, model, batch, weights = _tiny()
    b = {k: torch.as_tensor(v) for k, v in batch(0).items()}

    def fails(*a, **k):
        raise RuntimeError("a planted fault")
    monkeypatch.setattr(model.spatial_conv, "forward", fails)
    events, err = _traced(
        lambda: step(state, b, torch.Generator().manual_seed(0), weights,
                     CURRICULUM), tmp_path)
    assert "planted" in str(err)
    fwd = _ranges(events, "step.forward")
    enc = _ranges(events, "model.type_encoder")
    assert len(fwd) == len(enc) == 1 and _within(enc, fwd)
    assert _ranges(events, "step.backward") == []
    monkeypatch.undo()
    # the profiler's ranges are balanced: the next step's spans nest anew
    events, err = _traced(
        lambda: step(state, b, torch.Generator().manual_seed(1), weights,
                     CURRICULUM), tmp_path)
    assert err is None
    assert _within(_ranges(events, "model.type_encoder"),
                   _ranges(events, "step.forward"))


def test_span_is_a_shared_no_op_without_a_profiler():
    assert not torch.autograd.profiler._is_profiler_enabled
    off = spans.span("step.forward")
    assert isinstance(off, contextlib.nullcontext)
    assert spans.span("data.features") is off
    with off, off:                  # reentrant, and nested in itself
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        on = spans.span("step.forward")
        assert on is not off
        with on:
            pass
    assert spans.span("step.forward") is off


class _Dataset:
    """Synthetic FRL batches, as ``ForestDatasetV2.load_batch`` gives
    them."""

    def __init__(self, make, n):
        self.make, self.n = make, n

    def __len__(self):
        return self.n

    def on_epoch_start(self):
        pass

    def load_batch(self, idx):
        return self.make(int(idx[0]), b=len(idx))


def test_profile_trace_of_an_epoch_holds_the_loop_spans(tmp_path):
    from forest_tpu_torch.training.representation import loops, profiling
    state, step, _, batch, weights = _tiny()
    out = tmp_path / "trace"
    try:
        profiling.set_profile(True)
        with profiling.maybe_trace(str(out)):
            _, m = loops.run_epoch(
                _Dataset(batch, 2 * TINY_B), step, state,
                batch_size=TINY_B, weights=weights, curriculum=CURRICULUM,
                rng_seed=0, train=True, num_workers=2, device="cpu")
    finally:
        profiling.set_profile(False)
    assert m["n_steps"] == 2 and {"wait_s", "step_s"} <= set(m)
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    wait = _ranges(events, "loader.wait")
    assert len(wait) == 3                       # two batches and the end
    assert len(_ranges(events, "step.forward")) == 2
    assert len(_ranges(events, "epoch.fetch_metrics")) == 1
    assert _within(_ranges(events, "loader.h2d"), wait)
    load = [e for e in events if e.get("name") == "loader.load"]
    assert len(load) == 2
    main = {e["tid"] for e in events if e.get("name") == "loader.wait"}
    assert not {e["tid"] for e in load} & main  # on the workers' threads


@pytest.mark.parametrize("name", ["loader.wait", "step.forward"])
def test_span_closes_on_an_exception(name, tmp_path):
    def fn():
        with spans.span(name):
            raise RuntimeError("inside")
    events, err = _traced(fn, tmp_path)
    assert err is not None and len(_ranges(events, name)) == 1
