"""The control on the card: the plain reference computed with TF32 for its
float32 products, the precision below the configurations', put in the
port's place, is not correct by the cells' own limits; the port is. At
sizes a test run holds: the cells' widths, smaller batches but the FRL
cell's own."""
import copy
import importlib

import pytest

from gpu_bench import calibrate, harness

from small import ROOT

SIZES = {
    # the FRL cell at its own size: its limits are set from readings there
    "frl_v1.train_b12": {},
    "frl_v1.embed_b8": dict(batch_size=2, patch_size=128, checked=2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SIZES))
def test_the_control_is_not_correct(cell, cuda_device):
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wl = copy.deepcopy(harness.load_json(ROOT / "gpu_bench" / "workloads"
                                         / f"{cell}.json"))
    wl["traffic"].update(SIZES[cell])
    cfg = harness.load_json(ROOT / "gpu_bench" / "configs"
                            / f"{wl['config']}.json")
    driver = importlib.import_module(f"gpu_bench.drivers.{wl['driver']}")
    fails = {}
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        c = driver.Cell(cfg, wl, seed, cuda_device)
        fn = (calibrate._embedding if wl["driver"].startswith("embed")
              else calibrate._training)
        res = fn(c)
        lim = wl["limits"]
        assert all(res["port"][k] <= lim[k] for k in lim), res["port"]
        fails[seed] = [k for k in lim if res["control"][k] > lim[k]]
    assert all(fails.values()), fails
