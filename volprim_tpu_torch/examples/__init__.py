"""The port's example CLIs, run as ``python -m volprim_tpu_torch.examples.<name>``."""
