"""Parallel layouts of the port (port of `repro.parallel`): the mesh's
sharding rules in `sharding`, int8 error-feedback gradient compression
in `compress`, the GPipe schedule in `pipeline`."""
