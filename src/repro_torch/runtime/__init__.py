"""Fault tolerance of the training loop (`fault`) and elastic restart on
another mesh (`elastic`)."""
