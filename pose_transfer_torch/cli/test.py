"""Batch inference entry point: the test split's sample grids.

Counterpart of ``pose_transfer_tpu/cli/test.py``: the generator of the
latest checkpoint (the generator alone: a missing disc file is no error)
runs over the test split in order, one ``images_batch_{b:05d}.png`` grid
per full batch in ``generated_images_dir``.

Run: ``python -m pose_transfer_torch.cli.test --expID ... --resume 1
[--device cpu]``
"""

from __future__ import annotations

import dataclasses
import os

from ..data.dataset import PoseTransferDataset, collate
from ..train import checkpoint
from ..train.engine import create_state, make_eval_step, resolve_device
from ..utils.visualize import display, save_image
from .opts import Opts, config_from_opt


def inference_setup(opt):
    """(config, test dataset, eval step, epoch) of the latest checkpoint's
    generator, on ``opt.device``. The content-loss layer is a training
    option: the generator is built without it."""
    device = resolve_device(opt.device)
    config = config_from_opt(opt)
    dataset = PoseTransferDataset(vars(opt), "test")
    state = create_state(dataclasses.replace(config,
                                             content_loss_layer="none"),
                         seed=opt.seed, device=device)
    state, epoch = checkpoint.resume(state, opt.checkpoints_dir,
                                     require_disc=False)
    return config, dataset, make_eval_step(config, state.gen, device), epoch


def main(argv=None):
    opt = Opts().parse(argv)
    print("Model options . .")
    for k, v in sorted(vars(opt).items()):
        print("  %s: %s" % (str(k), str(v)))

    config, dataset, eval_step, epoch = inference_setup(opt)
    print(f"Running inference with epoch-{epoch} weights")
    num_batches = len(dataset) // config.batch_size
    for b in range(num_batches):
        batch = collate([dataset[b * config.batch_size + i]
                         for i in range(config.batch_size)])
        out, prepared = eval_step(batch)
        images = display(prepared["input"], prepared["target"], out,
                         config.use_input_pose, config.pose_dim)
        save_image(os.path.join(opt.generated_images_dir,
                                f"images_batch_{b:05d}.png"), images)
    print(f"Wrote {num_batches} grids to {opt.generated_images_dir}")


if __name__ == "__main__":
    main()
