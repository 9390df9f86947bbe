"""Sharded layouts and collectives over torch.distributed (the port of
calclens_tpu/parallel/)."""
