"""Model construction, the inference step, the two-phase GAN train step and
checkpoints."""
