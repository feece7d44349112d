"""models of the PyTorch port (mirrors trinerflet_tpu.models)."""
