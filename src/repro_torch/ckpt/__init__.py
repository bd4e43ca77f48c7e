"""Checkpointing (the reference's on-disk format)."""
