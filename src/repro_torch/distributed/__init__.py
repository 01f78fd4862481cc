"""Parallelism of the port: the logical-axis sharding rules."""
