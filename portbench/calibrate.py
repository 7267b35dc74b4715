"""Readings that the output check's limits are set from, on the card, in
one process:

    python3 -m portbench.calibrate --workload <cell> --seeds 1 2 3 ...
        [--control-seeds 1 2 3] [--seconds 5] [--out FILE]

For each seed, the program as a run drives it (``run.execute`` with a
short window) and the numbers it compares; for each control seed, the
same numbers of the control, the reference put in the program's place
with its convolutions in float8 (``check.fp8``; the content loss's VGG19
too), and for a training cell of the planted faults in ``VARIANTS`` that
its recipe can have. One JSON line per reading.
The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from . import check, run, serving, synthetic
from .cell import Run
from .traffic import train_steps


def _run(spec, seed, seconds) -> Run:
    return Run(cell=spec["name"], config=spec["config"], mix=spec["mix"],
               limits=spec["work"]["limits"], seed=seed, seconds=seconds,
               trace=False, device=torch.device("cuda"),
               t_start=time.perf_counter())


# the reference in the program's place, by the batch's rows: the control,
# and the planted faults that a run has to come out not correct under
VARIANTS = {
    "control": lambda n: {"q": check.fp8},
    # every loss over the first half of the rows, the forward left whole
    "half_batch": lambda n: {"loss_rows": n // 2},
    # the generator's Adam at ten times its rate
    "gen_lr10": lambda n: {"gen_lr_scale": 10.0},
    # the content loss at a 1 × 1 neighbourhood: no neighbour search
    "nn_area1": lambda n: {"nn_area": 1},
}
# the variants that only a recipe with a content layer can have
CONTENT_ONLY = ("nn_area1",)


def variants_of(config: dict) -> list[str]:
    """The ``VARIANTS`` that configuration ``config``'s recipe can have."""
    content = config.get("content_loss_layer", "none") != "none"
    return [v for v in VARIANTS if content or v not in CONTENT_ONLY]


def train_readings(r: Run, variants=None) -> dict:
    """{variant: the numbers ``train_steps`` compares} for each of
    ``variants`` (by default ``variants_of`` the configuration) put in the
    program's place, against the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pool = train_steps._pool(r, r.mix["batch"])
    n = r.mix["compared_steps"]
    weights = {net: train_steps._host(w)
               for net, w in train_steps._weights(r).items()}
    ref_losses, ref_outs, ref_grads, ref_after = train_steps._reference(
        r, pool, weights, n)
    keep = check.kept_leaves(ref_grads)
    base = {**{"gen." + k: v for k, v in weights["gen"].items()},
            **{"disc." + k: v for k, v in weights["disc"].items()}}
    ref_delta = {k: ref_after[k] - base[k] for k in ref_after}
    out = {}
    for name in variants or variants_of(r.config):
        losses, outs, grads, after = train_steps._reference(
            r, pool, weights, n, **VARIANTS[name](r.mix["batch"]))
        delta = {k: after[k] - base[k] for k in after}
        out[name] = {
            "output_gap": check.output_gap(outs, ref_outs),
            "grad_gap": check.norm_gap(grads, ref_grads, keep)[0],
            "grad_diff": check.diff_gap(grads, ref_grads, keep),
            "update_gap_net": check.net_gap(delta, ref_delta, keep),
            "update_gap": check.norm_gap(delta, ref_delta, keep)[0],
            "loss_gap": check.loss_gap(losses, ref_losses)}
    return out


def serve_readings(r: Run) -> dict:
    """The control's ``image_gap``: the reference with float8
    convolutions against the float32 reference over the cell's sample
    size of requests drawn from the seed."""
    rng = r.rng()
    reqs = [synthetic.request(rng, r.image_size, r.pose_dim,
                              r.mix.get("missing_prob", 0))
            for _ in range(r.mix["sample"])]
    want = serving.reference_images(r, reqs)
    got = serving.reference_images(r, reqs, q=check.fp8)
    return {"image_gap": float(check.image_gaps(got, want).max())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    spec = run.cell_spec(args.workload)
    training = spec["mix"]["kind"] == "train_steps"
    lines = []

    def emit(side, seed, numbers):
        line = json.dumps({"cell": args.workload, "side": side,
                           "seed": seed, **numbers})
        print(line, flush=True)
        lines.append(line)

    for seed in args.seeds:
        res = run.execute(spec, seed, args.seconds, False, "cuda",
                          time.perf_counter())
        numbers = {n: v for n, v, _ in res["checks"]}
        numbers.update(dict(res["readings"]))
        numbers.update({k: v for k, v in res["info"].items()
                        if k.endswith("_leaf") or k == "reference_peak_bytes"})
        emit("program", seed, numbers)
    for seed in args.control_seeds:
        r = _run(spec, seed, args.seconds)
        if training:
            for side, numbers in train_readings(r).items():
                emit(side, seed, numbers)
        else:
            emit("control", seed, serve_readings(r))
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
