"""The EINCM objective, the BFGS solvers and the coarse-to-fine pyramid."""
