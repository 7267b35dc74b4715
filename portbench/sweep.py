"""The knee of an open-loop serving cell: the highest offered rate at
which the 95th percentile stays within a limit and the generator keeps
to its schedule. Run once on the card, by hand; the cells themselves
offer a fixed rate.

    python3 -m portbench.sweep --workload <cell> --rates 40 60 80 \\
        [--seconds 10] [--seeds 1 2]

One JSON line per rate and seed: p50/p95/p99, the generator's lateness,
failures.
"""

from __future__ import annotations

import argparse
import json
import time

from . import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1])
    args = ap.parse_args(argv)
    spec = run.cell_spec(args.workload)
    for rate in args.rates:
        for seed in args.seeds:
            spec["mix"] = {**spec["mix"], "rate_per_s": rate}
            res = run.execute(spec, seed, args.seconds, False, "cuda",
                              time.perf_counter())
            _line(rate, seed, res)
    return 0


def _line(rate, seed, res) -> None:
    info = res["info"]
    print(json.dumps({
        "rate_per_s": rate, "seed": seed,
        "p95_ms": info["end_to_end"]["serve_p95_ms"],
        **{k: info[k] for k in ("p50_ms", "p99_ms", "late_ms_mean",
                                "late_ms_max")},
        "failed": res["result"]["failed"],
        "correct": res["result"]["correct"]}), flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
