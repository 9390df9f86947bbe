"""The benchmark of calclens_tpu_torch (run.py is its command)."""
