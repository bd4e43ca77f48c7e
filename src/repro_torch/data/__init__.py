"""Synthetic data sources."""
