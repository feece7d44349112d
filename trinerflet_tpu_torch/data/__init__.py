"""data of the PyTorch port (mirrors trinerflet_tpu.data)."""
