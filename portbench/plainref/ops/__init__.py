"""Geometry operators and the hand-written kernels' wrappers."""
