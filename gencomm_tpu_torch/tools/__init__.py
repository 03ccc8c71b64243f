"""Command-line entry points of the port (counterpart of ``gencomm_tpu/tools``)."""
