"""Host-side edge maps (numpy + scipy): Canny and inverse distance surfaces.

Re-exports the JAX package's names (eincm_tpu/edge/__init__.py)."""

from eincm_tpu_torch.edge.pipeline import (
    preprocess_image,
    image_to_edge,
    smoothen_edges,
    eincm_inv_exp_dist_transform,
    rtef_inv_exp_dist_transform,
    extract_edges,
)
