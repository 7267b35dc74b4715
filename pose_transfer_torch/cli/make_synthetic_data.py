"""Write a synthetic on-disk dataset in the reference layout (PNG images).

Counterpart of ``pose_transfer_tpu/cli/make_synthetic_data.py``, with the
same flags. It writes files only and touches no device.

Run: ``python -m pose_transfer_torch.cli.make_synthetic_data --out
/tmp/synth --dataset h36m --pose_dim 16``
"""

from __future__ import annotations

import argparse

from ..data.synthetic import write_synthetic_dataset

_SIZES = {"fasion": (256, 256), "h36m": (224, 224),
          "fasion128128": (128, 128), "fasion128": (128, 64),
          "market": (128, 64)}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--dataset", default="fasion128128",
                   choices=list(_SIZES))
    p.add_argument("--pose_dim", default=18, type=int)
    p.add_argument("--num_people", default=4, type=int)
    p.add_argument("--images_per_person", default=3, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--style", default="noise",
                   choices=["noise", "skeleton"],
                   help="skeleton = images render the pose itself, making "
                        "pose transfer learnable (convergence smoke test)")
    args = p.parse_args(argv)
    write_synthetic_dataset(
        args.out, dataset=args.dataset, pose_dim=args.pose_dim,
        num_people=args.num_people,
        images_per_person=args.images_per_person,
        img_size=_SIZES[args.dataset], seed=args.seed, style=args.style)
    print(f"Synthetic {args.dataset} dataset written to {args.out}")


if __name__ == "__main__":
    main()
