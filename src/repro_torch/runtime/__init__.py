"""Fault tolerance of the training loop."""
