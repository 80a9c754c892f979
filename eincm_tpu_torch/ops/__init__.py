"""Tensor ops of the solve: normalization, filters, resize, warp, splat.

Re-exports the JAX package's names (eincm_tpu/ops/__init__.py). Nothing
here builds or loads a CUDA library: `_build` does that at a kernel's
first launch."""

from eincm_tpu_torch.ops.splat import (
    events_to_pdf_frame,
    events_to_pdf_frame_scatter,
    event_counts,
    make_event_mask,
)
from eincm_tpu_torch.ops.warp import per_pix_warp, warp_events_multi_ref
from eincm_tpu_torch.ops.filters import (
    scharr_grads,
    gaussian_blur_3x3,
    divergence_filter,
    gradient_magnitude,
)
from eincm_tpu_torch.ops.resize import (
    scale_theta_to_sensor_size,
    upscale_theta,
    downscale_theta,
)
from eincm_tpu_torch.ops.normalize import normalize_to_unit_range, extract_tiles
