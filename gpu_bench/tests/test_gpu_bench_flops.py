"""The benchmark's own FLOP count against the port's count
(``forest_tpu_torch/utils/flops.step_flops``) at
3cfd860c7617988dff336bd92534bbc78565c650, written here as constants: the
FRL training step and the embedding forward at small sizes."""
import json

import pytest

from gpu_bench.costs import steps

from small import ROOT


def config(name):
    return json.loads((ROOT / "gpu_bench" / "configs"
                       / f"{name}.json").read_text())


@pytest.mark.parametrize("batch, hw, port", [(2, 64, 7580944272),
                                             (3, 48, 6878238402)])
def test_frl_training_step(batch, hw, port):
    assert sum(steps.frl_train(config("frl_v1"), batch, hw, 15).values()) \
        == port


@pytest.mark.parametrize("batch, hw, port", [(2, 32, 3089920000),
                                             (1, 48, 3476160000)])
def test_frl_embedding(batch, hw, port):
    assert sum(steps.frl_embed(config("frl_v1"), batch, hw, 15).values()) \
        == port


def test_the_frl_step_at_its_cell_splits_by_precision():
    f = steps.frl_train(config("frl_v1"), 12, 256, 15)
    assert round(sum(f.values()) / 1e9, 2) == 665.97
    assert f["bfloat16"] > f["float32"]
