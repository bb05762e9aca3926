"""The benchmark of gmmvi_tpu_torch on an NVIDIA card (see run.py)."""
