"""Part of the PyTorch port; mirrors the gencomm_tpu subpackage of the same name."""
