"""Measurement vehicles: the fused warp+splat and the dense-layout interp,
which nothing in the solver or the loss calls."""
