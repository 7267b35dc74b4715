"""Test settings of the benchmark's own tests (run apart from the
repository's ``tests/``): the ``cuda`` marker, and small shapes of the
cells for the CPU."""

import copy

import pytest

from portbench.cell import ROOT, load_json


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")


SMALL_MIX = {
    "train_steps": {"batch": 2, "pool": 4},
    "open_loop": {"batch_size": 2, "rate_per_s": 10.0, "sample": 4,
                  "warmup_batches": 1},
    "closed_loop": {"batch_size": 2, "outstanding": 4, "job_frames": 8,
                    "jobs": 2, "warmup_answers": 4,
                    "sample": 4, "sample_span": 8},
}


# traffic mixes that no cell of BENCHMARK.json runs yet, driven on the CPU
# all the same: name → (configuration, mix, limits)
UNLISTED = {
    "fashion256-serve-online-b8": ("fashion256", "online-b8",
                                   {"image_gap": 0.03}),
}


def small_spec(name: str, image: int = 64) -> dict:
    """Cell ``name`` as ``run.cell_spec`` reads it, cut to ``image``², a
    batch of 2 and float32 for the CPU; its limits as they stand. (At this
    size in bfloat16 the first gradient's ``grad_diff`` reads 0.05-0.08,
    where the cells themselves read under 0.01 on the card.)"""
    from portbench import run
    if name in UNLISTED:
        config, traffic, limits = UNLISTED[name]
        spec = {"name": name, "chips": 1,
                "work": {"config": config, "traffic": traffic, "chips": 1,
                         "limits": limits},
                "config": load_json(ROOT / "configs" / f"{config}.json"),
                "mix": load_json(ROOT / "traffic" / f"{traffic}.json"),
                "end_to_end": [], "per_layer": []}
    else:
        spec = copy.deepcopy(run.cell_spec(name))
    spec["config"]["image_size"] = [image, image]
    spec["config"]["compute_dtype"] = "float32"
    spec["mix"].update(SMALL_MIX[spec["mix"]["kind"]])
    return spec


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def small():
    return small_spec
