"""Parallel training of the port: meshes, the axis collectives, tensor
parallelism, ring and Ulysses attention, and the train steps."""
