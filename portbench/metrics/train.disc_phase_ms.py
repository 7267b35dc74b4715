"""``train.disc_phase_ms``: mean ms per step of ``TrainStep.disc_phase``,
from CUDA events the benchmark records around the instance's call."""


def read(out, run):
    ms = out.readings.get("phase_ms", {}).get("disc_phase")
    return sum(ms) / len(ms) if ms else None
