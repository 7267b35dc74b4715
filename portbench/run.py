"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads`` entry and
``portbench/workloads/<cell>.json``) names a configuration
(``portbench/configs/<config>.json``) and a traffic mix
(``portbench/traffic/<traffic>.json``), whose ``kind`` is the generator
module ``portbench/traffic/<kind>.py``. The run loads the program
(``pose_transfer_torch``), makes its weights and traffic from the seed,
warms up, measures for ``--seconds``, checks what the timed path produced
against the plain reference (``portbench/reference/``), and prints one
JSON line last on standard output: the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics (each read by
``portbench/metrics/<metric>.py``), the device, whether the outputs are
correct, and the numbers compared beside their limits, which also end
standard error. Needs as many CUDA devices as the cell asks for.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# numpy's BLAS pool at one thread, set before numpy loads: one process with
# few threads, whose host path is the client's and the batcher's Python
# threads (the request fits' small solves run on the client's)
os.environ["OPENBLAS_NUM_THREADS"] = "1"

from .cell import REPO, ROOT, Run, load_json  # noqa: E402

# top-level modules that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pose_transfer_tpu")
CACHE = ROOT / ".cache"


def cell_spec(name: str) -> dict:
    """Everything the files say about cell ``name``: its workload file,
    configuration, traffic mix, and the metrics ``BENCHMARK.json`` lists
    for it."""
    bench = load_json(REPO / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    work = load_json(ROOT / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if work[key] != entry[key]:
            raise SystemExit(f"workloads/{name}.json: {key} {work[key]!r} "
                             f"differs from BENCHMARK.json's {entry[key]!r}")
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return {"name": name, "chips": entry["chips"], "work": work,
            "config": load_json(ROOT / "configs" / f"{work['config']}.json"),
            "mix": load_json(ROOT / "traffic" / f"{work['traffic']}.json"),
            "end_to_end": e2e, "per_layer": per_layer}


def reader(metric: str):
    """The ``read(outcome, run)`` of ``portbench/metrics/<metric>.py`` (a
    file, since a metric's name holds dots)."""
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{metric}", ROOT / "metrics" / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def execute(spec: dict, seed: int, seconds: float, trace: bool, device,
            t_start: float) -> dict:
    """One run of a cell on ``device`` → {'result': the result line's
    object, 'checks': [(name, value, limit)], 'info': ...}."""
    import torch

    from . import breakdown

    kind = importlib.import_module(
        f"{__package__}.traffic.{spec['mix']['kind']}")
    device = torch.device(device)
    limits = spec["work"]["limits"]
    run = Run(cell=spec["name"], config=spec["config"], mix=spec["mix"],
              limits=limits, seed=seed, seconds=seconds, trace=trace,
              device=device, t_start=t_start)
    out = kind.run(run)
    quantities = {"setup_s": out.setup_s,
                  "peak_mem_gib": out.memory_peak_bytes / 2**30, **out.e2e}
    metrics = {}
    if trace:
        for m in spec["per_layer"]:
            value = reader(m["name"])(out, run)
            if value is not None:
                metrics[m["name"]] = {"value": _finite(value),
                                      "unit": m["unit"]}
    else:
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": _finite(quantities[m["name"]]),
                                  "unit": m["unit"]}
    checks = [(name, value, limits[name]) for name, value in out.checks
              if name in limits]
    readings = [(name, value) for name, value in out.checks
                if name not in limits]
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": spec["chips"],
           "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": dev}
    if trace:
        tr = out.window.trace
        dev["busy_s"] = _busy_s(tr)
        dev["window_s"] = tr.window_s
        result["breakdown"] = breakdown.breakdown(tr)
    result["checks"] = {name: {"value": _finite(v), "limit": lim}
                        for name, v, lim in checks}
    return {"result": result, "checks": checks, "readings": readings,
            "info": {**run.notes, **out.info,
                     "end_to_end": quantities}}


def _finite(value: float) -> float:
    """A number JSON can carry: a latency or gap that never came (+inf)
    is written as 1e12."""
    return value if math.isfinite(value) else 1e12


def _busy_s(tr) -> float:
    from .measure import busy_seconds
    return busy_seconds(tr.intervals(), tr.start, tr.end) / 1e9


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one no run may load."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def _card_line() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache of the program and its libraries inside the checkout, at
    # fixed paths
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    spec = cell_spec(args.workload)

    import torch
    t_torch = time.perf_counter() - T_START
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < spec["chips"]:
        print(f"{args.workload} needs {spec['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(json.dumps({"card": _card_line(), "torch": torch.__version__,
                      "cuda": torch.version.cuda}), file=sys.stderr,
          flush=True)
    t_card = time.perf_counter() - T_START
    res = execute(spec, args.seed, args.seconds, bool(args.trace), "cuda",
                  T_START)
    res["info"].setdefault("setup_marks", {}).update(
        {"torch": round(t_torch, 3), "card": round(t_card, 3)})
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process, which the benchmark forbids: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(res["info"], default=str), file=sys.stderr)
    for name, value in res["readings"]:
        print(f"reading {name} {value!r} (no limit)", file=sys.stderr)
    for name, value, limit in res["checks"]:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res["result"]), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
