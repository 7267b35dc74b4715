"""pose_transfer_torch — the PyTorch/CUDA port of ``pose_transfer_tpu``.

Serves and trains the deformable pose-transfer GAN on an NVIDIA H100. The
module layout mirrors ``pose_transfer_tpu`` so that each module's
counterpart is found under the same name:

  core/      keypoint schemas, heatmaps, host-side affine estimation (numpy)
  data/      compact batches, synthetic requests, in-step batch preparation
  ops/       mask rasterization, volume instance norm, the warp fold with
             its backward (``ops.warp.WarpFold``) and its kernels
             (``ops.warp_fused.fold_place``, ``ops.warp_fused.fold_route``)
  models/    the deformable generator, the discriminator and the flax →
             torch weight mapping
  train/     ``GANConfig``, model construction, the inference step, the
             losses and the two-phase GAN train step
  serve.py   static-shape micro-batching inference server
  tools/     device-time profiles of serving and training
  csrc/      hand-written CUDA C++ kernels, built by ``_build`` at first use

The package imports neither JAX nor ``pose_transfer_tpu``. Public functions
keep the JAX package's NHWC layout; the convolution stacks run NCHW views of
``channels_last`` tensors. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""

__version__ = "0.1.0"
