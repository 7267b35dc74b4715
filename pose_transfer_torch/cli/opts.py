"""Flag-compatible configuration of the command-line entry points.

Counterpart of ``pose_transfer_tpu/cli/opts.py``: every flag with the same
name, default and choices, the same ``derive`` (experiment directories,
the dataset's image size and file paths, the ``opt.txt`` dump) and
``config_from_opt``. The port adds one flag, ``--device`` (default
``cuda``; ``cpu`` runs on the CPU, as the tests do).

Flags whose paths are not ported raise ``NotImplementedError`` naming
their ``ROADMAP.md`` item rather than run something else:
``--warp_backend exact`` (§A item 8), ``--gen_type stacked|unet`` and
``--weight_init gaussian`` (§A item 7), a training
``--content_loss_layer`` other than ``none`` (§A item 6, through
``train.engine``) and ``--num_devices`` above 1 (§A item 10); 0 and 1 run
on one device.
"""

from __future__ import annotations

import argparse
import os


class Opts:
    def __init__(self):
        self.parser = argparse.ArgumentParser(
            description="Pose guided image generation using deformable "
                        "skip layers — PyTorch/CUDA port")

    def init(self):
        p = self.parser
        p.add_argument("--expID", default="default", help="Experiment ID")
        p.add_argument("--data_Dir",
                       default="../../pose-gan-clean/pose-gan-h36m-fg/data/",
                       help="Directory with annotations and data")
        p.add_argument("--output_dir", default="output/displayed_samples",
                       help="Directory with generated sample images")
        p.add_argument("--batch_size", default=4, type=int)
        p.add_argument("--log_file", default="output/full/fasion/log")
        p.add_argument("--training_ratio", default=1, type=int,
                       help="discriminator updates per generator update")
        p.add_argument("--resume", default=0, type=int)
        p.add_argument("--learning_rate", default=2e-4, type=float)
        p.add_argument("--l1_penalty_weight", default=100, type=float)
        p.add_argument("--gan_penalty_weight", default=1, type=float)
        p.add_argument("--tv_penalty_weight", default=0, type=float)
        p.add_argument("--lstruct_penalty_weight", default=0, type=float)
        p.add_argument("--number_of_epochs", default=500, type=int)
        p.add_argument("--content_loss_layer", default="none",
                       help="vgg19 layer name e.g. block1_conv2, or none")
        p.add_argument("--pose_dim", default=16, type=int)
        p.add_argument("--iters_per_epoch", default=1000, type=int)
        p.add_argument("--checkpoints_dir", default="output/checkpoints")
        p.add_argument("--checkpoint_ratio", default=5, type=int)
        p.add_argument("--generator_checkpoint", default=None)
        p.add_argument("--discriminator_checkpoint", default=None)
        p.add_argument("--nn_loss_area_size", default=1, type=int)
        p.add_argument("--dataset", default="h36m",
                       choices=["market", "fasion", "fasion128",
                                "fasion128128", "h36m"])
        p.add_argument("--frame_diff", default=10, type=int)
        p.add_argument("--num_stacks", default=4, type=int)
        p.add_argument("--compute_h36m_paf_split", default=0, type=int)
        p.add_argument("--display_ratio", default=50, type=int)
        p.add_argument("--start_epoch", default=0, type=int)
        p.add_argument("--pose_estimator", default="pose_estimator.h5")
        p.add_argument("--images_for_test", default=12000, type=int)
        p.add_argument("--use_input_pose", default=True, type=int)
        p.add_argument("--warp_skip", default="mask",
                       choices=["none", "full", "mask"])
        p.add_argument("--warp_agg", default="max", choices=["max", "avg"])
        p.add_argument("--disc_type", default="call",
                       choices=["call", "sim", "warp"])
        p.add_argument("--gen_type", default="baseline",
                       choices=["baseline", "stacked", "unet"],
                       help="baseline/stacked as the reference; 'unet' = "
                            "the baseline tree's plain single-encoder U-Net "
                            "(only 'baseline' is ported)")
        p.add_argument("--generated_images_dir",
                       default="output/generated_images")
        p.add_argument("--load_generated_images", default=0, type=int)
        p.add_argument("--use_dropout_test", default=0, type=int)

        # baseline-tree extras
        p.add_argument("--checkMode", default=0, type=int,
                       help="tiny model + small data for smoke tests")
        p.add_argument("--images_for_train", default=100000, type=int)

        # the JAX package's additions
        p.add_argument("--exp_root", default="../exp",
                       help="experiment-dir root (reference hardcoded ../exp)")
        p.add_argument("--compute_dtype", default="float32",
                       choices=["float32", "bfloat16"])
        p.add_argument("--num_devices", default=0, type=int,
                       help="data-parallel devices (0 = all visible; the "
                            "port runs on one)")
        p.add_argument("--prefetch", default=1, type=int,
                       help="device prefetch depth for the input pipeline")
        p.add_argument("--seed", default=0, type=int)
        p.add_argument("--serve_host", default="127.0.0.1",
                       help="bind address for cli.serve")
        p.add_argument("--serve_port", default=8710, type=int,
                       help="port for cli.serve (0 = ephemeral)")
        p.add_argument("--max_wait_ms", default=5.0, type=float,
                       help="serving micro-batch admission window")
        p.add_argument("--vgg_weights", default=None,
                       help="torch VGG19 state_dict path for content loss")
        p.add_argument("--vgg_preprocess", default="correct",
                       choices=["correct", "reference"],
                       help="reference = reproduce the reshape quirk")
        p.add_argument("--profile_steps", default=0, type=int,
                       help="capture a torch.profiler trace of N train "
                            "steps to <expdir>/trace")
        p.add_argument("--warp_backend", default="matmul",
                       choices=["matmul", "exact"],
                       help="matmul = two-pass banded warp; exact = gather "
                            "bilinear (not ported)")
        p.add_argument("--warp_windowed", default="auto",
                       choices=["auto", "0", "1"],
                       help="mask-windowed warp fold: auto = on with the "
                            "placement kernel (CUDA), else batch >= 16")
        p.add_argument("--warp_place", default="auto",
                       choices=["auto", "kernel", "xla"],
                       help="windowed-fold placement: the fold_place kernel "
                            "or gather/scatter chains; auto = kernel on CUDA")
        p.add_argument("--weight_init", default="xavier",
                       choices=["xavier", "gaussian"],
                       help="xavier = glorot uniform; gaussian = N(0, 0.02) "
                            "conv kernels (not ported)")

        # the port's addition
        p.add_argument("--device", default="cuda",
                       help="torch device; cuda must exist unless 'cpu' is "
                            "given")

    def parse(self, args=None):
        self.init()
        opt = self.parser.parse_args(args)
        return self.derive(opt)

    @staticmethod
    def derive(opt):
        """Derived config: image size, dataset paths, experiment dirs,
        opt.txt dump."""
        opt.saveDir = os.path.join(opt.exp_root, opt.expID)
        opt.output_dir = os.path.join(opt.exp_root, opt.expID, "results")
        opt.checkpoints_dir = os.path.join(opt.exp_root, opt.expID, "models")
        opt.generated_images_dir = os.path.join(
            opt.exp_root, opt.expID, "results", "generated")

        if opt.dataset == "fasion":
            opt.image_size = (256, 256)
        elif opt.dataset == "h36m":
            opt.image_size = (224, 224)
        elif opt.dataset == "fasion128128":
            opt.image_size = (128, 128)
        else:
            opt.image_size = (128, 64)

        d, ds = opt.data_Dir, opt.dataset
        opt.images_dir_train = d + ds + "-dataset/train"
        opt.images_dir_test = d + ds + "-dataset/test"
        opt.annotations_file_train = d + ds + "-annotation-train.csv"
        opt.annotations_file_test = d + ds + "-annotation-test.csv"
        opt.annotations_file_train_paf = (
            d + ds + "-annotation-paf-train"
            + str(opt.compute_h36m_paf_split) + ".csv")
        opt.annotations_file_test_paf = (
            d + ds + "-annotation-paf-test"
            + str(opt.compute_h36m_paf_split) + ".csv")
        opt.pairs_file_train = d + ds + "-pairs-train.csv"
        opt.pairs_file_test = d + ds + "-pairs-test.csv"
        opt.pairs_file_train_iterative = d + ds + "-pairs-train-iterative.csv"
        opt.pairs_file_test_iterative = d + ds + "-pairs-test-iterative.csv"
        opt.pairs_file_train_interpol = d + ds + "-pairs-train-interpol.csv"
        opt.pairs_file_test_interpol = d + ds + "-pairs-test-interpol.csv"
        opt.pairs_file_train_check = d + ds + "-pairs-train-check.csv"
        opt.pairs_file_test_check = d + ds + "-pairs-test-check.csv"
        opt.tmp_pose_dir = "tmp/" + ds + "/"

        os.makedirs(opt.saveDir, exist_ok=True)
        for sub in ("train", "test"):
            os.makedirs(os.path.join(opt.output_dir, sub), exist_ok=True)
        os.makedirs(opt.generated_images_dir, exist_ok=True)
        os.makedirs(opt.checkpoints_dir, exist_ok=True)

        with open(os.path.join(opt.saveDir, "opt.txt"), "wt") as f:
            f.write("==> Args:\n")
            for k, v in sorted(vars(opt).items()):
                f.write("  %s: %s\n" % (str(k), str(v)))
            f.write("==> Args:\n")
        return opt


def config_from_opt(opt):
    """GANConfig from parsed opts (``--compute_dtype`` included); raises
    ``NotImplementedError`` for the flags whose paths are not ported, and
    for ``--num_devices`` above 1."""
    from ..train.engine import GANConfig

    if opt.warp_backend == "exact":
        raise NotImplementedError(
            "--warp_backend exact: the gather-bilinear warp is not ported "
            "(ROADMAP.md §A item 8)")
    if opt.gen_type != "baseline":
        raise NotImplementedError(
            f"--gen_type {opt.gen_type}: the stacked and U-Net generators "
            "are not ported (ROADMAP.md §A item 7)")
    if opt.weight_init != "xavier":
        raise NotImplementedError(
            f"--weight_init {opt.weight_init}: only the Glorot (xavier) "
            "init is ported (ROADMAP.md §A item 7)")
    if opt.num_devices > 1:
        raise NotImplementedError(
            f"--num_devices {opt.num_devices}: data-parallel runs are not "
            "ported (ROADMAP.md §A item 10)")
    print(f"Running on one device ({opt.device}); data-parallel runs "
          "(--num_devices > 1) are not ported")
    return GANConfig.from_opt(opt)
