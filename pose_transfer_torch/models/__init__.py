"""The deformable generator, the discriminator, VGG19 features and the flax
weight mapping."""
