"""Parallel training of the port (data parallel in this slice)."""
