"""Roofline bounds of the port's kernels."""
