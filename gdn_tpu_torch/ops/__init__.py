"""Plain PyTorch ops of the port (counterparts of gdn_tpu/ops)."""
