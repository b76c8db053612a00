"""The cell of the FRL CLI's own epoch (``frl_v1.train_cli``): its cube
written and read back, dry runs on the CPU at a small size, the faults it
can have coming out as not correct, and (``cuda``) the cell and its
control on the card at its own size.

The cell's files are in the harness, but ``BENCHMARK.json`` does not list
it: its rate spreads over runs by more than a bound may allow (PERF.md
§7). The tests enter it, with its metrics, into a copy of the benchmark
as the entries that would add it."""
import copy
import importlib
import json

import numpy as np
import pytest
import torch

from gpu_bench import calibrate, harness
from gpu_bench.drivers.train_cli import same
from gpu_bench.reference.data.cube_read import Array, Cube
from gpu_bench.traffic import cube as traffic_cube

from small import ROOT, bench

CELL = "frl_v1.train_cli"
SMALL = dict(batch_size=2, patch_size=64, cube_hw=256, chunk=64, steps=2,
             num_workers=2, checked=2, trace_units=1)
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checked"}
SEED = 2**31 + 21


def config():
    return harness.load_json(ROOT / "gpu_bench" / "configs" / "frl_v1.json")


def workload(**small):
    wl = copy.deepcopy(harness.load_json(
        ROOT / "gpu_bench" / "workloads" / f"{CELL}.json"))
    wl["traffic"].update(small)
    return wl


def cli_bench():
    """BENCHMARK.json with the cell, its rate under
    ``frl_train_patches_per_s`` and its three per-layer metrics."""
    b = bench()
    b["workloads"].append({"name": CELL, "config": "frl_v1",
                           "traffic": "train_cli", "chips": 1,
                           "why": workload()["why"]})
    for m in b["end_to_end"]:
        if m["name"] == "frl_train_patches_per_s":
            m["workloads"].append(CELL)
    for name, unit, source, layer in (
            ("loader_wait_pct.frl_cli", "%", "host_clock", "data.loader"),
            ("loader_load_ms.frl_cli", "ms", "host_clock", "data.loader"),
            ("device_idle_pct.frl_cli", "%", "device_trace", "device")):
        b["per_layer"].append({"name": name, "unit": unit, "better": "lower",
                               "source": source, "layer": layer,
                               "moves": "frl_train_patches_per_s",
                               "workloads": [CELL]})
    return b


def run(trace=False, seed=SEED, **small):
    return harness.run(CELL, seed, 0.5, trace, device="cpu",
                       bench=cli_bench(),
                       workload=workload(**dict(SMALL, **small)))


def test_the_cube_round_trips_and_the_plain_read_is_the_datasets(tmp_path):
    """A 512² cube: every array the port's reader reads back is what the
    plain read reads, and an epoch's batches of the CLI's dataset, 2 steps
    of 2 patches, equal the plain read of the same patches bit for bit."""
    from forest_tpu_torch.data import blosc1, zarrlite
    from forest_tpu_torch.data.bindings import parse_bindings
    from forest_tpu_torch.data.frl_dataset import ForestDatasetV2
    cfg = config()
    t = dict(workload()["traffic"], cube_hw=512, chunk=128)
    path = tmp_path / "cube.zarr"
    info = traffic_cube.write(path, torch.Generator().manual_seed(SEED),
                              cfg["bindings"], t)
    assert 0 < info["whole_chunks"] < info["chunks"]
    assert 0 < info["stored_bytes"] < info["raw_bytes"]
    plain = Cube(path, cfg["bindings"], 256, t["min_aoi"])
    assert plain.patches == [(0, 0), (0, 256), (256, 0), (256, 256)]
    port = zarrlite.open_zarr(path)
    for src in ("static/topo/data/topo_0", "annual/lcms/data/ysfc",
                "annual/ccdc/mask/ok", "static/evt/data/evt", "aoi"):
        a = Array(path.joinpath(*src.split("/")))
        full = a.read(slice(0, 512), slice(0, 512))
        assert np.array_equal(port[src][tuple(slice(None) for _ in a.shape)],
                              full), src
        key = "0.1.2" if len(a.shape) == 3 else "1.2"
        raw = (a.path / key).read_bytes()
        assert blosc1.decompress(raw) == a.chunk(
            tuple(map(int, key.split(".")))).tobytes()
    ysfc = Array(path / "annual/lcms/data/ysfc").read(slice(0, 512),
                                                      slice(0, 512))
    assert ysfc.dtype == np.float16 and ysfc.min() >= 0 \
        and ysfc.max() < t["ysfc_max"] and np.all(ysfc == np.round(ysfc))
    bindings = copy.deepcopy(cfg["bindings"])
    bindings["zarr"]["path"] = str(path)
    ds = ForestDatasetV2(parse_bindings(bindings), split=None,
                         patch_size=256, min_aoi=t["min_aoi"])
    order = traffic_cube.visits(SEED, 1, len(ds.patches), 2, 2)
    ds._current_indices = order
    for k in range(2):
        got = ds.load_batch(list(range(2 * k, 2 * k + 2)))
        want = plain.batch(order[2 * k:2 * k + 2])
        want.pop("__sample_valid__")
        assert set(got) == set(want)
        for name, v in want.items():
            assert same(torch.from_numpy(got[name]), v), name


def _streams(kind, n, gen):
    if kind == "mask":
        return (torch.rand(n, generator=gen) < 0.9).to(torch.uint8).numpy()
    if kind == "three codes":
        return (torch.randint(0, 3, (n,), generator=gen) + 0x59).to(
            torch.uint8).numpy()
    if kind == "constant":
        return np.full(n, 0x1B, np.uint8)
    if kind == "period 3":
        return np.resize(np.array([1, 2, 3], np.uint8), n)
    if kind == "long literals then a run":
        x = torch.randint(0, 256, (n,), generator=gen).to(torch.uint8).numpy()
        x[n // 2:] = 7
        return x
    return torch.randint(0, 256, (n,), generator=gen).to(torch.uint8).numpy()


@pytest.mark.parametrize("n", [5, 12, 13, 300, 16384])
@pytest.mark.parametrize("kind", ["mask", "three codes", "constant",
                                  "period 3", "long literals then a run",
                                  "noise"])
def test_the_writers_lz4_streams_decode_by_both_readers(kind, n):
    """The cube writer's LZ4 encoder: a stream it encodes is shorter than
    the stream and decodes to it by the plain read's decoder and by the
    port's; one it cannot shorten (noise, or under 13 bytes, which LZ4
    keeps as literals) is left to be stored."""
    from forest_tpu_torch.data import blosc1
    from gpu_bench.reference.data.cube_read import lz4
    src = _streams(kind, n, torch.Generator().manual_seed(n))
    dst = np.empty_like(src)
    size = np.zeros(1, np.int32)
    traffic_cube.lz4_library().lz4_streams(src.ctypes.data, 1, n, 7,
                                           dst.ctypes.data, size.ctypes.data)
    size = int(size[0])
    if kind == "noise" or n < 13:
        assert size == 0
    elif n >= 300:
        assert 0 < size < n
    if not size:
        return
    coded = dst[:size].tobytes()
    assert lz4(coded, n) == src.tobytes()
    assert bytes(blosc1.lz4_block(coded, 0, size, n)) == src.tobytes()


def test_an_epochs_visits_repeat_patches_but_never_inside_a_batch():
    order = traffic_cube.visits(SEED, 3, 36, 12, 24)
    assert len(order) == 288 and sorted(set(order)) == list(range(36))
    assert all(len(set(order[i:i + 12])) == 12 for i in range(0, 288, 12))
    assert order == traffic_cube.visits(SEED, 3, 36, 12, 24)
    assert order != traffic_cube.visits(SEED, 4, 36, 12, 24)


@pytest.mark.parametrize("trace", [False, True])
def test_dry_run_of_the_cli_cell_keeps_the_contract(trace):
    out = json.loads(json.dumps(run(trace)))
    assert set(out) == KEYS | ({"breakdown"} if trace else set())
    assert list(out)[-1] == "checked"
    assert out["correct"] is True and out["failed"] == 0, out["checked"]
    assert out["attempted"] >= 1
    want = {m["name"] for m in harness.cell_metrics(cli_bench(), CELL,
                                                    trace)}
    # the device's idle share is read only where a device ran
    assert set(out["metrics"]) == want - {"device_idle_pct.frl_cli"}
    if trace:
        assert 0.0 <= out["metrics"]["loader_wait_pct.frl_cli"][
            "value"] <= 100.0
        assert out["metrics"]["loader_load_ms.frl_cli"]["value"] > 0.0
    assert set(out["checked"]) == set(workload()["limits"])


def _neighbour(load_batch):
    """The dataset's batch with its first patch's values taken from the
    patch beside it in the grid, its window left as it was."""
    def wrapped(self, indices):
        out = load_batch(self, indices)
        win = self.patches[self._current_indices[
            int(np.atleast_1d(indices)[0])]]
        beside = next(w for w in self.patches
                      if w.row_start == win.row_start
                      and abs(w.col_start - win.col_start)
                      == self.patch_size)
        for name, g in self.bindings.dataset.items():
            out[name][0] = self._load_group(g, beside)
        return out
    return wrapped


def _dropped(iterate):
    """The loader's iteration without its second batch."""
    def wrapped(self):
        for k, batch in enumerate(iterate(self)):
            if k != 1:
                yield batch
    return wrapped


def _float16_zeros(getitem):
    """The cube's float16 arrays read back as zeros."""
    def wrapped(self, sel):
        out = getitem(self, sel)
        return np.zeros_like(out) if self.dtype == np.float16 else out
    return wrapped


def _half_valid(decode):
    def wrapped(batch, device):
        batch = decode(batch, device)
        n = batch["__sample_valid__"].shape[0]
        keep = torch.arange(n, device=batch["__sample_valid__"].device) \
            < n // 2
        return dict(batch, __sample_valid__=keep)
    return wrapped


def _faults():
    from forest_tpu_torch.data import frl_dataset, loader, zarrlite
    from forest_tpu_torch.training.representation import train_step
    return {
        "neighbouring patch": (frl_dataset.ForestDatasetV2, "load_batch",
                               _neighbour(frl_dataset.ForestDatasetV2.
                                          load_batch)),
        "dropped batch": (loader.PrefetchLoader, "__iter__",
                          _dropped(loader.PrefetchLoader.__iter__)),
        "float16 as zeros": (zarrlite.ZarrArray, "__getitem__",
                             _float16_zeros(zarrlite.ZarrArray.__getitem__)),
        "state unchanged": (train_step, "apply_update",
                            lambda *a, **k: None),
        "half batch": (train_step, "decode_wire_batch",
                       _half_valid(train_step.decode_wire_batch)),
    }


@pytest.mark.parametrize("fault", ["neighbouring patch", "dropped batch",
                                   "float16 as zeros", "state unchanged",
                                   "half batch"])
def test_a_fault_in_the_cli_path_is_not_correct(fault, monkeypatch):
    owner, name, planted = _faults()[fault]
    monkeypatch.setattr(owner, name, planted)
    out = run(steps=3, checked=3)
    assert out["correct"] is False, out["checked"]


@pytest.mark.cuda
def test_the_cli_cell_is_correct_on_the_card(cuda_device):
    """The cell at its own size, a short window, the committed limits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = harness.run(CELL, 2**31 + 31, 5.0, False, device="cuda",
                      bench=cli_bench())
    assert out["correct"] is True, out["checked"]
    assert out["failed"] == 0


@pytest.mark.cuda
def test_the_control_of_the_cli_cell_is_not_correct(cuda_device):
    """At the cell's own size on three seeds: the port's compared steps
    under the limits, the reference with TF32 in its place over one."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wl = workload()
    driver = importlib.import_module(f"gpu_bench.drivers.{wl['driver']}")
    lim = {k: v for k, v in wl["limits"].items()
           if k in driver.TRAINING}
    fails = {}
    for seed in (2**31 + 41, 2**31 + 42, 2**31 + 43):
        res = calibrate._training(driver.Cell(config(), wl, seed,
                                              cuda_device))
        assert all(res["port"][k] <= lim[k] for k in lim), res["port"]
        fails[seed] = [k for k in lim if res["control"][k] > lim[k]]
    assert all(fails.values()), fails
