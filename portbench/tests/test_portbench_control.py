"""The control fails the output check: the reference put in the program's
place with its convolutions in float8 reads above the cell's limit. On
the CPU at a small size; on the card (``cuda``) at the cell's own size."""

import json
import time
from pathlib import Path

import pytest
import torch

from portbench import calibrate, run
from portbench.cell import Run

CELLS = [w["name"] for w in json.loads(
    (Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())
    ["workloads"]]


def _control_fails(spec, device, seed) -> None:
    r = Run(cell=spec["name"], config=spec["config"], mix=spec["mix"],
            limits=spec["work"]["limits"], seed=seed, seconds=1.0,
            trace=False, device=torch.device(device),
            t_start=time.perf_counter())
    if spec["mix"]["kind"] == "train_steps":
        numbers = calibrate.train_readings(r, ["control"])["control"]
    else:
        numbers = calibrate.serve_readings(r)
    limits = spec["work"]["limits"]
    assert any(numbers[k] > limits[k] for k in limits), (numbers, limits)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_small(cell, small):
    _control_fails(small(cell), "cpu", 2**32 + 5)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cell, cuda_device):
    _control_fails(run.cell_spec(cell), cuda_device, 2**32 + 6)
