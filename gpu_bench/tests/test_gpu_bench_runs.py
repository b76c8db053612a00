"""Runs of each driver at a small size on the CPU: the result line's keys,
a new cell and metric added by files alone, and the faults each cell can
have coming out as not correct."""
import json
import shutil
import subprocess
import sys

import pytest
import torch

from gpu_bench import harness

from small import ROOT, SMALL, bench, workload

CELLS = sorted(SMALL)
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checked"}


def run(cell, trace=False, seed=2**31 + 11):
    return harness.run(cell, seed, 0.5, trace, device="cpu", bench=bench(),
                       workload=workload(cell))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_dry_run_prints_the_contract_keys(cell, trace):
    line = json.dumps(run(cell, trace))
    out = json.loads(line)
    assert set(out) == KEYS | ({"breakdown"} if trace else set())
    assert list(out)[-1] == "checked"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(out["metrics"]) == {
            m["name"] for m in harness.cell_metrics(bench(), cell, False)}
    for v in out["checked"].values():
        assert set(v) == {"value", "limit"}


def test_a_new_cell_and_metric_are_files_alone(tmp_path):
    """A copy of the harness runs a newly dropped workload file and metric
    file, with BENCHMARK.json's entries for them and no other edit."""
    shutil.copytree(ROOT / "gpu_bench", tmp_path / "gpu_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    wl = workload("frl_v1.embed_b8")
    wl["traffic"].update(batch_size=1, patch_size=48)
    (tmp_path / "gpu_bench" / "workloads" / "frl_v1.embed_b1.json"
     ).write_text(json.dumps(wl))
    (tmp_path / "gpu_bench" / "metrics" / "units_per_window.embed.py"
     ).write_text("def read(run):\n    return float(run.window.units)\n")
    b["workloads"].append({"name": "frl_v1.embed_b1", "config": "frl_v1",
                           "traffic": "embed_b1", "chips": 1, "why": "x"})
    for m in b["end_to_end"]:
        if m["name"] == "embed_patches_per_s":
            m["workloads"].append("frl_v1.embed_b1")
    b["end_to_end"].append({"name": "units_per_window.embed", "unit": "1",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock",
                            "workloads": ["frl_v1.embed_b1"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    script = ("import json, sys\nfrom gpu_bench import harness\n"
              "r = harness.run('frl_v1.embed_b1', 5, 0.3, False, "
              "device='cpu')\nprint(json.dumps(r))\n")
    env = {"PYTHONPATH": f"{tmp_path}:{ROOT}", "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert set(res["metrics"]) == {"setup_s", "embed_patches_per_s",
                                   "units_per_window.embed"}
    assert res["metrics"]["units_per_window.embed"]["value"] == \
        res["attempted"]


def _half_valid(decode):
    """A compact-wire decode that also marks the second half of the batch
    as padding, so the losses take their means over the first half."""
    def wrapped(batch, device):
        batch = decode(batch, device)
        n = next(v for k, v in batch.items() if not k.startswith("__"))
        keep = torch.arange(n.shape[0], device=n.device) < n.shape[0] // 2
        return dict(batch, __sample_valid__=keep)
    return wrapped


def _altered(make):
    """encode_type whose answer is altered where it is made."""
    def wrapped(*a, **k):
        encode_type, encode_phase, project = make(*a, **k)

        def altered(batch):
            z = encode_type(batch).clone()
            z[0, 0, 0] += z.abs().max()
            return z
        return altered, encode_phase, project
    return wrapped


def _raises_once(make):
    """make_encode_phase_dense whose second call raises, as a batch that
    fails in the window."""
    def wrapped(*a, **k):
        encode_phase, calls = make(*a, **k), []

        def raising(*b, **kb):
            calls.append(1)
            if len(calls) == 2:
                raise RuntimeError("a planted fault")
            return encode_phase(*b, **kb)
        return raising
    return wrapped


def _faults():
    from forest_tpu_torch.eval import export_embeddings, frozen
    from forest_tpu_torch.training.representation import train_step
    no_update = lambda *a, **k: None                      # noqa: E731
    return [
        ("frl_v1.train_b12", "state unchanged", train_step, "apply_update",
         no_update),
        ("frl_v1.train_b12", "half batch", train_step, "decode_wire_batch",
         _half_valid(train_step.decode_wire_batch)),
        ("frl_v1.embed_b8", "answer altered", frozen, "make_encode_fns",
         _altered(frozen.make_encode_fns)),
        ("frl_v1.embed_b8", "a batch raises", export_embeddings,
         "make_encode_phase_dense",
         _raises_once(export_embeddings.make_encode_phase_dense)),
    ]


@pytest.mark.parametrize("i", range(4))
def test_a_fault_in_the_timed_path_is_not_correct(i, monkeypatch):
    cell, _, module, name, fault = _faults()[i]
    monkeypatch.setattr(module, name, fault)
    out = run(cell)
    assert out["correct"] is False, out["checked"]
