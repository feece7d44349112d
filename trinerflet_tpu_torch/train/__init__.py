"""train of the PyTorch port (mirrors trinerflet_tpu.train)."""
