"""The H100 benchmark of autovc_tpu_torch: see run.py."""
