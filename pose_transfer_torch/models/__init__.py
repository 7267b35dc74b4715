"""The deformable generator and the flax weight mapping."""
