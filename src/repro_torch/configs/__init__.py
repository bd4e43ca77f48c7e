"""Configurations of the ported system (copies of `repro.configs` modules)."""
