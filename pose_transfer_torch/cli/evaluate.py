"""Quantitative evaluation: SSIM, L1, PSNR and VGG feature distances over
the test split.

Counterpart of ``pose_transfer_tpu/cli/evaluate.py``: the latest
checkpoint's generator (the stacked one's last stage) runs over the test
split and one JSON line reports mean SSIM (``value``), L1, PSNR (of the
[0, 1] remap, peak 1.0) and, unless
``--feat_layer none``, the mean L2 and L1 between the VGG19 features of
output and target and ``feat_nn`` (``ops.nn_loss`` over them, area 5).
The VGG weights come from ``--vgg_weights``, else the port's seeded random
init (``models.vgg.random_vgg19_features(0)``).

Run: ``python -m pose_transfer_torch.cli.evaluate --expID ... --resume 1
[--max_batches N] [--feat_layer block1_conv2] [--device cpu]
[--num_devices k]`` (k generator replicas, as ``cli.test``)
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..data.dataset import collate
from ..ops.nn_loss import nn_loss
from ..ops.ssim import ssim
from .opts import Opts
from .test import inference_setup


def _metrics(a: torch.Tensor, b: torch.Tensor):
    # images are [-1, 1]: PSNR over the [0, 1] remap (peak 1.0)
    mse = ((a - b) * 0.5).square().mean()
    psnr = -10.0 * torch.log10(torch.clamp(mse, min=1e-10))
    return ssim(a, b), (a - b).abs().mean(), psnr


def evaluate(opt, max_batches: int | None = None,
             feat_layer: str | None = None) -> dict:
    config, dataset, eval_step, epoch = inference_setup(opt)
    device = torch.device(opt.device)   # the outputs' (the first replica's)
    if feat_layer is None:
        feat_layer = getattr(opt, "feat_layer", "block1_conv2")
    vgg = None
    if feat_layer != "none":
        from ..models import vgg as vgg_mod
        if getattr(opt, "vgg_weights", None):
            vgg = vgg_mod.load_torch_vgg19_features(opt.vgg_weights, device)
        else:
            vgg = vgg_mod.random_vgg19_features(0, device)
        feat_index = vgg_mod.get_layer_ind(feat_layer)

    def _feat_metrics(a, b):
        from ..models.vgg import extract_features
        # 'correct' preprocessing, as in the JAX package, whose
        # --vgg_preprocess flag reaches no config
        fa = extract_features(vgg, a, feat_index)
        fb = extract_features(vgg, b, feat_index)
        d = fa - fb
        # feat_nn: the flagship recipe's training objective (area 5)
        return d.square().mean(), d.abs().mean(), nn_loss(fa, fb, 5, 5)

    n_batches = len(dataset) // config.batch_size
    if max_batches:
        n_batches = min(n_batches, max_batches)
    rows = []
    for b in range(n_batches):
        batch = collate([dataset[b * config.batch_size + i]
                         for i in range(config.batch_size)])
        out, prepared = eval_step(batch)
        if config.gen_type == "stacked":
            out = out[-1]       # the metrics read the last stage
        out32 = out.float()
        tgt32 = prepared["target"].float()
        with torch.inference_mode():
            vals = _metrics(out32, tgt32)
            if vgg is not None:
                vals += _feat_metrics(out32, tgt32)
        rows.append([float(v) for v in vals])
    cols = np.mean(np.asarray(rows, np.float64), axis=0) if rows \
        else [float("nan")] * (6 if vgg is not None else 3)
    result = {
        "metric": "test_ssim",
        "value": round(float(cols[0]), 5),
        "l1": round(float(cols[1]), 5),
        "psnr": round(float(cols[2]), 3),
        "epoch": epoch,
        "num_batches": n_batches,
    }
    if vgg is not None:
        result["feat_l2"] = round(float(cols[3]), 6)
        result["feat_l1"] = round(float(cols[4]), 6)
        result["feat_nn"] = round(float(cols[5]), 6)
        result["feat_layer"] = feat_layer
    return result


def main(argv=None):
    p = Opts()
    p.init()
    p.parser.add_argument("--max_batches", default=0, type=int)
    p.parser.add_argument("--feat_layer", default="block1_conv2",
                          help="VGG19 layer for the feature-distance "
                               "metric ('none' disables)")
    opt = Opts.derive(p.parser.parse_args(argv))
    result = evaluate(opt, opt.max_batches or None)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
