"""Parallelism layer of the port (so far only the dense attention oracle)."""
