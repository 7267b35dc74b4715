"""Mask rasterization, volume instance norm and the warp fold."""
