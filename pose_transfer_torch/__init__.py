"""pose_transfer_torch — the PyTorch/CUDA port of ``pose_transfer_tpu``.

Serves the deformable pose-transfer generator on an NVIDIA H100. The module
layout mirrors ``pose_transfer_tpu`` so that each module's counterpart is
found under the same name:

  core/      keypoint schemas, heatmaps, host-side affine estimation (numpy)
  data/      compact batches, synthetic requests, in-step batch preparation
  ops/       mask rasterization, volume instance norm, the warp fold and
             its placement kernel (``ops.warp_fused.fold_place``)
  models/    the deformable generator and the flax → torch weight mapping
  train/     ``GANConfig``, ``build_models`` and ``make_eval_step``
  serve.py   static-shape micro-batching inference server
  csrc/      hand-written CUDA C++ kernels, built by ``_build`` at first use

The package imports neither JAX nor ``pose_transfer_tpu``. Public functions
keep the JAX package's NHWC layout; the convolution stacks run NCHW views of
``channels_last`` tensors. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""

__version__ = "0.1.0"
