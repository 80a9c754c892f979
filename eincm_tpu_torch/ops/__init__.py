"""Tensor ops of the solve: normalization, filters, resize, warp, splat."""
