"""render of the PyTorch port (mirrors trinerflet_tpu.render)."""
