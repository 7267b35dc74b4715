"""Pose geometry: keypoint schemas, heatmaps, host-side affine estimation."""
