"""Runnable demos of the port (`python -m eincm_tpu_torch.examples.<name>`)."""
