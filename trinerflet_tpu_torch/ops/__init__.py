"""ops of the PyTorch port (mirrors trinerflet_tpu.ops)."""
