"""Traffic kind ``train_steps``: the two-phase training step on a pool of
compact batches drawn from the seed and cycled.

Parameters (``traffic/<mix>.json``): ``batch``; ``pool``, the number of
(disc_fake, disc_real, gen) triples; ``content_seed``; ``missing_prob``;
``compared_steps``, the first steps that the reference follows.

Every seed trains on the same pool, drawn from ``content_seed``, in an
order drawn from ``--seed`` (the weights and the dropout draws are the
seed's own): how much work a step is depends on its rows (a limb whose
mask outgrows its window sends a whole fold instance to the full scan),
so a pool of its own per seed would change the work from seed to seed.

Set-up builds the training state and its step once (the program's
``create_state`` and ``make_train_step``), loads the benchmark's weights
(with a content layer the VGG19's too, from the seed ``vgg_weights``),
seeds the dropout draws, and drives the first ``compared_steps`` steps
through the step's own call on the first triples of the pool (rows that
all differ). They warm up every shape the window uses. The window then
runs the same object on the pool in turn until ``--seconds`` have passed
and ends on a synchronise. A step consumes N·(2·training_ratio + 1)
images.

The reference follows the configuration's recipe (``reference.train.
recipe``), which refuses, before set-up, one that it does not compute.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from .. import check, measure, synthetic
from ..cell import Outcome, fold_launch_recorder, launch_counts
from ..reference import model as ref
from ..reference import train as ref_train
from ..trace import Window

BETA1 = 0.5


def _pool(r, batch: int) -> list:
    """The mix's pool of triples, in the seed's order."""
    rng = np.random.default_rng(r.mix["content_seed"])
    draw = lambda: synthetic.compact_batch(  # noqa: E731
        rng, batch, r.image_size, r.pose_dim, r.mix["missing_prob"])
    lead = lambda b: {k: v[None] for k, v in b.items()}  # noqa: E731
    pool = [(lead(draw()), lead(draw()), draw())
            for _ in range(r.mix["pool"])]
    return [pool[i] for i in r.rng().permutation(len(pool))]


def _phase_timer(step, name: str, marks: list):
    """Wrap the instance's ``name`` phase in CUDA events."""
    fn = getattr(step, name)

    def timed(*a, **k):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = fn(*a, **k)
        e.record()
        marks.append((name, s, e))
        return out

    setattr(step, name, timed)


def _host(leaves: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in leaves.items()}


def _first_grads(module, opt, prefix: str) -> dict:
    """Each leaf's gradient as Adam got it at its first step, from its
    first moment m₁ = (1 − β₁)·g (zero where Adam holds no state)."""
    out = {}
    for name, p in module.named_parameters():
        m = opt.state.get(p, {}).get("exp_avg")
        out[prefix + name] = torch.zeros_like(p) if m is None \
            else m / (1.0 - BETA1)
    return _host(out)


def _weights(r) -> dict:
    """The benchmark's weights on the device: {'gen', 'disc'}, and 'vgg'
    where the recipe has a content layer."""
    nets = ["gen", "disc"]
    if r.config.get("content_loss_layer", "none") != "none":
        nets.append("vgg")
    return {net: r.weights(net) for net in nets}


def run(r) -> Outcome:
    from pose_transfer_torch.train.engine import create_state, make_train_step

    batch = r.mix["batch"]
    cfg = r.program_config(batch)
    ref_train.recipe(r.config)
    r.note_implementation(cfg)
    seeds = r.seeds()
    r.mark("imports")
    pool = _pool(r, batch)
    r.mark("traffic")
    weights = _weights(r)
    r.mark("weights")
    state = create_state(cfg, seed=0, device=r.device)
    r.mark("create_state")
    state.gen.load_state_dict(weights["gen"])
    state.disc.load_state_dict(weights["disc"])
    if "vgg" in weights:
        state.vgg.load_state_dict(weights["vgg"])
    # the benchmark's copies wait on the host: the device's peak is the
    # program's own
    weights = {net: _host(w) for net, w in weights.items()}
    gw, dw = weights["gen"], weights["disc"]
    state.rng.manual_seed(seeds["dropout"])
    step = make_train_step(cfg, state)

    n_cmp = r.mix["compared_steps"]
    losses, outs = [], []
    for i in range(n_cmp):
        metrics, out = step(*pool[i])
        losses.append(metrics["disc"].tolist() + metrics["gen"].tolist())
        outs.append(out.float().cpu())
        r.mark(f"step{i + 1}")
        if i == 0:
            grads = {**_first_grads(state.gen, state.gen_opt, "gen."),
                     **_first_grads(state.disc, state.disc_opt, "disc.")}
    after = _host({**{"gen." + k: v for k, v in state.gen.named_parameters()},
                   **{"disc." + k: v
                      for k, v in state.disc.named_parameters()}})

    marks, records, undo = [], [], None
    if r.trace:
        for name in ("disc_phase", "gen_phase"):
            _phase_timer(step, name, marks)
        records, undo = fold_launch_recorder()
    counts0 = launch_counts()
    setup_s = time.perf_counter() - r.t_start
    steps = 0
    try:
        with Window(r.trace, r.device) as win:
            while True:
                step(*pool[(n_cmp + steps) % len(pool)])
                steps += 1
                if win.elapsed() >= r.seconds:
                    break
    finally:
        if undo is not None:
            undo()
    peak = torch.cuda.max_memory_allocated(r.device) \
        if r.device.type == "cuda" else 0
    images = steps * batch * (2 * cfg.training_ratio + 1)
    flops = (measure.train_step_flops(r.image_size, r.pose_dim, batch)
             + measure.content_flops(r.image_size, cfg.content_loss_layer,
                                     batch)) * steps
    phase_ms = {}
    for name, s, e in marks:
        phase_ms.setdefault(name, []).append(s.elapsed_time(e))
    counts = {k: v - counts0[k] for k, v in launch_counts().items()}
    del step, state, metrics, out
    gc.collect()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(r.device)

    ref_losses, ref_outs, ref_grads, ref_after = _reference(r, pool, weights,
                                                            n_cmp)
    keep = check.kept_leaves(ref_grads)
    grad_gap, grad_leaf = check.norm_gap(grads, ref_grads, keep)
    grad_diff = check.diff_gap(grads, ref_grads, keep)
    delta = {k: after[k] - (gw[k[4:]] if k.startswith("gen.")
                            else dw[k[5:]]) for k in after}
    ref_delta = {k: ref_after[k] - (gw[k[4:]] if k.startswith("gen.")
                                    else dw[k[5:]]) for k in ref_after}
    update_gap, update_leaf = check.norm_gap(delta, ref_delta, keep)
    update_gap_net = check.net_gap(delta, ref_delta, keep)
    ref_peak = torch.cuda.max_memory_allocated(r.device) \
        if r.device.type == "cuda" else 0
    return Outcome(
        setup_s=setup_s, window=win, memory_peak_bytes=peak,
        attempted=steps, failed=0,
        e2e={"train_img_per_s": images / win.seconds},
        checks=[("output_gap", check.output_gap(outs, ref_outs)),
                ("grad_gap", grad_gap), ("grad_diff", grad_diff),
                ("update_gap_net", update_gap_net),
                ("update_gap", update_gap),
                ("loss_gap", check.loss_gap(losses, ref_losses))],
        readings={"phase_ms": phase_ms, "launch_records": records,
                  "flops": flops, "steps": steps},
        info={"steps": steps, "images": images, "counters": counts,
              "grad_gap_leaf": grad_leaf, "update_gap_leaf": update_leaf,
              "reference_peak_bytes": ref_peak,
              "leaves_left_out": sorted(set(ref_grads) - set(keep)),
              "losses": losses, "reference_losses": ref_losses})


def _reference(r, pool, weights, n_steps, q=ref.ident, loss_rows=None,
               gen_lr_scale=1.0, nn_area=None):
    """The reference's first ``n_steps`` steps of the configuration's
    recipe from the benchmark's weights (``_weights``, on the host),
    batches and dropout seed, float32 with TF32 off → (losses, generator
    outputs, first gradients, parameters after the steps), keyed 'gen.' /
    'disc.'. The control and the planted faults: ``q`` on the
    convolutions' operands, the losses over ``loss_rows`` rows, the
    generator's Adam at ``gen_lr_scale`` × the rate, the content loss's
    neighbourhood at ``nn_area``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    recipe = ref_train.recipe(r.config)
    if nn_area is not None:
        recipe = dataclasses.replace(recipe, nn_area=nn_area)
    gp, dp, vp = ({k: v.to(r.device) for k, v in weights[net].items()}
                  if net in weights else None
                  for net in ("gen", "disc", "vgg"))
    gopt = ref_train.Adam(recipe.learning_rate * gen_lr_scale)
    dopt = ref_train.Adam(recipe.learning_rate)
    dropout = torch.Generator(device=r.device)
    dropout.manual_seed(r.seeds()["dropout"])
    losses, outs = [], []
    for i in range(n_steps):
        fake, real, gen_b = pool[i]
        prep = [ref.prepare(b, r.image_size, r.device) for b in
                ({k: v[0] for k, v in fake.items()},
                 {k: v[0] for k, v in real.items()}, gen_b)]
        out = ref_train.train_step(gp, dp, gopt, dopt, *prep, recipe,
                                   dropout, q, loss_rows, vp)
        losses.append(out["disc"] + out["gen"])
        outs.append(out["out"].cpu())
        if i == 0:
            grads = {**{"gen." + k: v for k, v in out["gen_grads"].items()},
                     **{"disc." + k: v
                        for k, v in out["disc_grads"].items()}}
    after = {**{"gen." + k: v for k, v in gp.items()},
             **{"disc." + k: v for k, v in dp.items()}}
    return losses, outs, _host(grads), _host(after)
