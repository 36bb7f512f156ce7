"""Each cell's control comes out not correct: the plain reference in a
precision below the configuration's, put in the program's place, breaks a
limit of the cell: TF32 for the plan cells' float32, int8 for the training
cells' bf16 (int8 and float8 are the two formats one step below bf16; in
``train8k`` float8 reads within the sound runs' spread and is not caught).
Needs the card; run there with
``python -m pytest -q -m requires_cuda perfbench/tests``."""
import pytest
import torch

from perfbench import calibrate
from perfbench.harness import registry, runner

SIFT_CELLS = ["sift-262k.matvec8", "sift-262k.build"]
TRAIN_CELLS = ["minicpm3-4b.train8k", "minicpm3-4b.train2k"]
SEEDS = [2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cell", SIFT_CELLS)
def test_tf32_control_fails_the_plan_cells(cell):
    dev = _card()
    for seed in SEEDS:
        ctx = runner.Context(cell, seed, dev)
        got = calibrate.sift_control(ctx)
        assert any(v > ctx.limits[k] for k, v in got.items()), got


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_int8_control_fails_the_train_cells(cell):
    """At 4 of the configuration's layers, so that a test run holds it."""
    dev = _card()
    m = registry.config("minicpm3-4b")
    ctx = runner.Context(cell, SEEDS[0], dev,
                         sizes={"num_hidden_layers": 4})
    got = calibrate.train_reading(ctx, "control")
    assert any(v > ctx.limits[k] for k, v in got.items()
               if k in ctx.limits), (got, m["num_hidden_layers"])
