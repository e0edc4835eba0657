"""Entry-point scripts of the port (``python -m ddr_tpu_torch.cli``)."""
