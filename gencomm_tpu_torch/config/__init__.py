"""Hypes-YAML configs of the port (counterpart of ``gencomm_tpu/config``)."""

from gencomm_tpu_torch.config.yaml_utils import load_yaml, save_yaml  # noqa: F401
