"""eincm_tpu_torch — EINCM (Edge-Informed Contrast Maximization) on PyTorch
and CUDA.

A port of the JAX package `eincm_tpu`, which stays the reference. The
hot path of a window solve (coarse-theta interpolation at each event and
the image-of-warped-events splat) runs in hand-written CUDA kernels for
Hopper (`csrc/`), built with nvcc at first use; on CPU tensors each kernel
module uses its plain PyTorch version. The package never imports JAX.

Top-level API:

    from eincm_tpu_torch import (
        SolverConfig, HandoverSettings, WindowSample, LossParams,
        make_window_solver, solve_window,
    )
"""

__version__ = "0.1.0"

from eincm_tpu_torch.models.loss import LossParams, LossStatics
from eincm_tpu_torch.models.pyramid import (
    HandoverSettings,
    SolveResult,
    SolverConfig,
    WindowSample,
    make_window_solver,
    solve_window,
)
