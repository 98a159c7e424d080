"""Pose-graph back end: rotation averaging and the per-batch correction."""
