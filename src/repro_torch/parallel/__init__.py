"""Parallel layouts of the port (port of `repro.parallel`): the serving
mesh's sharding rules in `sharding`."""
