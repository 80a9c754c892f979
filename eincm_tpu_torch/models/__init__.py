"""The EINCM objective, the BFGS solvers and the coarse-to-fine pyramid.

Re-exports the objectives and the loss under the JAX package's names
(eincm_tpu/models/__init__.py)."""

from eincm_tpu_torch.models.objectives import (
    compute_mean_gradient_magnitude,
    compute_variance,
    compute_adaptive_mean_gradient_magnitude,
    compute_adaptive_variance,
    compute_mean_squared_error,
    compute_sum_squared_error,
    compute_mean_hadamard_product,
    compute_sum_hadamard_product,
    compute_joint_contrast,
    compute_adaptive_mean_squared_error,
    iwe_divergence,
    per_pix_total_variation,
    per_pix_theta_divergence,
    compute_fwl,
)
from eincm_tpu_torch.models.loss import (
    LossParams,
    LossStatics,
    compute_weights_for_multi_reference,
    compute_loss_objectives,
    loss_func,
    handover_loss_func,
)
