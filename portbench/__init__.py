"""The benchmark of volprim_tpu_torch on one NVIDIA H100 per cell; see
run.py."""
