"""The port's examples (``examples/torch_*.py``) against the JAX package's
(``examples/*.py``), on the CPU.

Each JAX example runs through ``runpy`` in a child process
(``tests/torch_examples_child.py``; the long ones one a process, the short
ones in turn in a third), all three started at once by a module fixture:
they compile op by op on the CPU, ~100 s in all, while the port's take a
few seconds. Each port example's ``main(["--device", "cpu"])`` returns the
values of every line it printed, by line, and its ``LINES`` hold the lines'
formats. Every line the JAX example printed must match the port's
format for the same line (so the two print the same text), and each number
in it must be within half a unit of its last printed digit plus 1e-5 of
itself of the port's value at full precision; shapes, counts, indices and
other text exactly; temporary paths are not compared.

- losses: the twelve demos, on the same numpy draws;
- encoders: with each block's weights carried from the JAX example's (its
  ``jax.random.key(0)`` inits, ``utils.flax_bridge.params_from_flax``); the
  RepresentationModel's parameter count exactly, and every block's outputs
  (the smoothing block's output and gate, FiLM's gamma and beta, z_type,
  z_phase, the VQ-VAE's z_e) within 1e-5 of the largest magnitude (the
  loss bound of ``chip_smoke.py``'s phase 8), the VQ-VAE's indices
  equal; without weights the port seeds its own, the same on every call;
- check_evt_tau: the synthetic demo and the ``--confusion/--counts`` form;
- compute_stats: the synthetic demo and the ``--bindings`` form, whose
  stats JSON must equal the JAX example's (univariate entries exactly,
  covariances to 1e-6, as ``test_torch_train_representation.py`` holds
  the two ``StatsCalculator``);
- dataset: the cube summary, splits, groups, stats and features;
- quickstart: the port's alone (the JAX one is covered by the e2e suites,
  as ``tests/test_examples_smoke.py`` says): it ends with ``quickstart OK``
  and prints no NaN;
- every example refuses ``--device cuda`` where there is no card.
"""
import json
import math
import os
import pickle
import re
import runpy
import string
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
CHILD = Path(__file__).resolve().parent / "torch_examples_child.py"
OUTPUT_REL = 1e-5     # chip_smoke.py STEP_LOSS_REL_BOUND (phase 8)
PORT_EXAMPLES = ("torch_example_losses.py", "torch_example_encoders.py",
                 "torch_check_evt_tau.py", "torch_example_compute_stats.py",
                 "torch_example_dataset.py", "torch_example_quickstart.py")
EVT_CODES = (7001, 7002, 7003, 7004, 7005, 7006)


def port(script: str) -> dict:
    """The globals of a port example, loaded as a module (not run)."""
    return runpy.run_path(str(EXAMPLES / script), run_name="port_example")


class JaxRuns:
    """The JAX examples, one process each, all started at once."""

    def __init__(self, tmp: Path):
        self.tmp = tmp
        (tmp / "jax_tmp").mkdir()
        # XLA's backend optimisations off: each eager op compiles ~25 %
        # faster, and every printed digit stays the same
        xla_flags = " ".join(filter(None, [
            os.environ.get("XLA_FLAGS"),
            "--xla_backend_optimization_level=0"]))
        self.env = dict(os.environ, JAX_PLATFORMS="cpu",
                        PYTHONPATH=str(ROOT), TMPDIR=str(tmp / "jax_tmp"),
                        XLA_FLAGS=xla_flags)
        # the longest first; the short ones share a process
        self.procs = {
            "losses": self._start([["losses", "example_losses.py"]]),
            "encoders": self._start("--encoders", str(tmp / "encoders.pkl"))}
        self.inputs = self._inputs(tmp)
        self.procs["rest"] = self._start([
            ["evt_tau", "check_evt_tau.py"],
            ["evt_tau_csv", "check_evt_tau.py", *self.inputs["tau_args"]],
            ["stats_demo", "example_compute_stats.py"],
            ["stats_bindings", "example_compute_stats.py", "--bindings",
             str(self.inputs["bindings"]["jax"]), "--patch-size", "32"],
            ["dataset", "example_dataset.py"]])
        self.done = {}

    def _start(self, *args):
        if isinstance(args[0], list):
            args = (json.dumps(args[0]),)
        return subprocess.Popen(
            [sys.executable, str(CHILD), *args], cwd=str(self.tmp),
            env=self.env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)

    @staticmethod
    def _inputs(tmp: Path) -> dict:
        from forest_tpu_torch.data.cube_v2 import (build_synthetic_v2_cube,
                                                   synthetic_bindings)
        from forest_tpu_torch.losses.evt_soft_neighborhood import (
            write_synthetic_confusion_csv)

        csv = write_synthetic_confusion_csv(tmp / "conf.csv", EVT_CODES)
        counts = tmp / "counts.json"
        counts.write_text(json.dumps({str(c): 50 * (i + 1) for i, c in
                                      enumerate(EVT_CODES)}))
        build_synthetic_v2_cube(tmp / "cube.zarr", height=96, width=96,
                                chunk_yx=32)
        bindings = {}
        for who in ("jax", "port"):
            bindings[who] = tmp / f"bindings_{who}.yaml"
            bindings[who].write_text(yaml.safe_dump(synthetic_bindings(
                tmp / "cube.zarr", tmp / f"stats_{who}.json")))
        return {"tau_args": ["--confusion", str(csv), "--counts",
                             str(counts), "--min-count", "100"],
                "bindings": bindings,
                "stats": {w: tmp / f"stats_{w}.json" for w in bindings}}

    def stdout(self, label: str) -> str:
        """What the JAX example run under ``label`` printed."""
        proc = label if label in self.procs else "rest"
        if proc not in self.done:
            out, err = self.procs[proc].communicate(timeout=600)
            assert self.procs[proc].returncode == 0, \
                f"JAX {proc} failed:\n{err[-3000:]}"
            self.done[proc] = out
        if proc == "encoders":
            return self.done[proc]
        runs = re.split(r"^### (\w+)\n", self.done[proc], flags=re.M)
        return dict(zip(runs[1::2], runs[2::2]))[label]

    def close(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module", autouse=True)
def jax_runs(tmp_path_factory):
    # the JAX children compile on one core each: leave them the others
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    runs = JaxRuns(tmp_path_factory.mktemp("jax_examples"))
    try:
        yield runs
    finally:
        runs.close()
        torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def port_tmp(tmp_path, monkeypatch):
    """The port examples' temporary directories go under tmp_path."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


NUMBER = r"\s*[-+]?(?:\d+(?:\.\d*)?|nan|inf)"


def line_pattern(fmt: str):
    """A format of ``LINES`` as a regex: a field with a float spec matches a
    number, any other field any text. -> (regex, [(field, spec)])."""
    parts, fields = [], []
    for literal, field, spec, _ in string.Formatter().parse(fmt):
        parts.append(re.escape(literal))
        if field is not None:
            pattern = NUMBER if spec.endswith("f") else ".*"
            parts.append(f"(?P<{field}>{pattern})")
            fields.append((field, spec))
    return re.compile("".join(parts)), fields


def hold_to_jax(jax_stdout: str, got: dict, lines: dict) -> int:
    """Hold the port's values (``got``: line key -> values, or a list of
    them for a repeated line) to the lines the JAX example printed, in
    order. Returns the number of values compared."""
    want = jax_stdout.splitlines()
    expected = [(key, v) for key, vals in got.items() if key in lines
                for v in (vals if isinstance(vals, list) else [vals])]
    assert len(want) == len(expected), (
        f"JAX printed {len(want)} lines, the port {len(expected)}:\n"
        + "\n".join(want))
    n = 0
    for line, (key, values) in zip(want, expected):
        rx, fields = line_pattern(lines[key])
        m = rx.fullmatch(line)
        assert m, f"{key}: JAX printed {line!r}, the port's format is " \
                  f"{lines[key]!r}"
        for name, spec in fields:
            printed = m.group(name)
            if name == "path":          # a temporary directory
                continue
            n += 1
            if spec.endswith("f"):
                p, v = float(printed), float(values[name])
                decimals = int(spec.split(".")[1][:-1])
                bound = 0.5 * 10.0 ** -decimals + 1e-5 * abs(p)
                assert abs(v - p) <= bound, \
                    f"{key}.{name}: port {v!r}, JAX printed {printed}"
            else:
                assert format(values[name], spec) == printed, \
                    f"{key}.{name}: port {values[name]!r}, JAX {printed!r}"
    return n


def run_port(script: str, argv, capsys, **kw) -> dict:
    mod = port(script)
    out = mod["main"](list(argv), **kw)
    printed = capsys.readouterr().out
    # a printed NaN, not the letters in a temporary directory's name
    assert not re.search(r"\bnan\b", printed.lower()), printed
    return mod, out, printed


def test_quickstart_ends_ok(capsys):
    _, out, printed = run_port("torch_example_quickstart.py",
                               ["--device", "cpu"], capsys)
    assert printed.rstrip().splitlines()[-1] == "quickstart OK"
    assert "codebook_export.npz" in out["codebook"]["path"]
    r2 = np.asarray(out["probe"]["r2_val"], np.float64)
    assert r2.shape == (2,) and np.isfinite(r2).all()
    for row in out["vqvae_history"] + out["frl_history"]:
        assert math.isfinite(row["train/loss_total"]), row


def test_losses_match_jax(jax_runs, capsys):
    mod, out, _ = run_port("torch_example_losses.py", ["--device", "cpu"],
                           capsys)
    assert hold_to_jax(jax_runs.stdout("losses"), out, mod["LINES"]) == 36


def _encoders_jax(jax_runs) -> dict:
    jax_runs.stdout("encoders")
    return pickle.loads((jax_runs.tmp / "encoders.pkl").read_bytes())


def test_encoders_match_jax_with_its_weights(jax_runs, capsys):
    from forest_tpu_torch.utils.flax_bridge import params_from_flax

    ref = _encoders_jax(jax_runs)
    params = {k: params_from_flax(v) for k, v in ref["params"].items()}
    mod, out, _ = run_port("torch_example_encoders.py", ["--device", "cpu"],
                           capsys, params=params)
    assert hold_to_jax(jax_runs.stdout("encoders"), out, mod["LINES"]) == 12
    assert out["representation"]["n_params"] == ref["n_params"]
    got, want = out["tensors"], ref["outputs"]
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["vq_indices"], want["vq_indices"])
    for name in sorted(want):
        if name == "vq_indices":
            continue
        assert got[name].shape == want[name].shape, name
        scale = float(np.abs(want[name]).max())
        err = float(np.abs(got[name] - want[name]).max())
        assert err <= OUTPUT_REL * scale, (name, err, scale)
    for key, name, field in (("smoothing", "gate", "gate_mean"),
                             ("film", "gamma", "gamma_mean"),
                             ("film", "beta", "beta_mean")):
        mean = float(np.mean(want[name], dtype=np.float64))
        assert abs(out[key][field] - mean) <= \
            OUTPUT_REL * float(np.abs(want[name]).max()), (field, mean)


def test_encoders_seed_their_own_weights(capsys):
    mod = port("torch_example_encoders.py")
    a = mod["main"](["--device", "cpu"])
    b = mod["main"](["--device", "cpu"])
    for name, v in a["tensors"].items():
        np.testing.assert_array_equal(v, b["tensors"][name], err_msg=name)
    # the FiLM heads start near identity, as flax initialises them
    assert abs(a["film"]["gamma_mean"] - 1.0) < 0.05
    assert abs(a["film"]["beta_mean"]) < 0.05
    with pytest.raises(ValueError, match="no block named"):
        mod["main"](["--device", "cpu"], params={"encoder": {}})
    capsys.readouterr()


@pytest.mark.parametrize("form", ["demo", "confusion"])
def test_check_evt_tau_matches_jax(jax_runs, form, capsys):
    argv = ["--device", "cpu"]
    if form == "confusion":
        argv += jax_runs.inputs["tau_args"]
    mod, out, _ = run_port("torch_check_evt_tau.py", argv, capsys)
    name = "evt_tau" if form == "demo" else "evt_tau_csv"
    n = hold_to_jax(jax_runs.stdout(name), out, mod["LINES"])
    assert len(out["sweep"]) == 6 and n >= 2 + 3 * 6


def test_compute_stats_demo_matches_jax(jax_runs, capsys):
    mod, out, _ = run_port("torch_example_compute_stats.py",
                           ["--device", "cpu"], capsys)
    hold_to_jax(jax_runs.stdout("stats_demo"), out, mod["LINES"])
    assert [f["name"] for f in out["feature"]] == list(out["stats"])


def test_compute_stats_bindings_matches_jax(jax_runs, capsys):
    """The required stats step on a bindings file: the same lines, and the
    same stats JSON as the JAX example's."""
    inputs = jax_runs.inputs
    mod, out, _ = run_port(
        "torch_example_compute_stats.py",
        ["--device", "cpu", "--bindings", str(inputs["bindings"]["port"]),
         "--patch-size", "32"], capsys)
    hold_to_jax(jax_runs.stdout("stats_bindings"), out, mod["LINES"])
    assert Path(out["wrote"]["path"]) == inputs["stats"]["port"]
    got = json.loads(inputs["stats"]["port"].read_text())
    want = json.loads(inputs["stats"]["jax"].read_text())
    assert list(got) == list(want)
    n_cov = 0
    for fname, entries in want.items():
        assert list(got[fname]) == list(entries), fname
        for ref, entry in entries.items():
            if ref == "__covariance__":
                n_cov += 1
                for k in ("matrix", "mean"):
                    np.testing.assert_allclose(got[fname][ref][k], entry[k],
                                               rtol=1e-6,
                                               err_msg=f"{fname} {k}")
                assert got[fname][ref]["n"] == entry["n"]
            else:
                assert got[fname][ref] == entry, (fname, ref)
    assert n_cov == 2


def test_dataset_matches_jax(jax_runs, capsys):
    mod, out, _ = run_port("torch_example_dataset.py", ["--device", "cpu"],
                           capsys)
    hold_to_jax(jax_runs.stdout("dataset"), out, mod["LINES"])
    assert out["locations"]["equal"] is True
    assert [s["split"] for s in out["split"]] == ["train", "val", "test"]


@pytest.mark.parametrize("script", PORT_EXAMPLES)
def test_examples_refuse_cuda_without_a_card(script, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is a valid device here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port(script)["main"](["--device", "cuda"])
    assert capsys.readouterr().out == ""
