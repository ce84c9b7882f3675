"""Collectives and kernels of the port."""

from .collective import (Handle, HorovodInternalError, allgather,
                         allgather_async, allreduce, allreduce_async,
                         broadcast, broadcast_async, grouped_allreduce, poll,
                         synchronize)

__all__ = ["Handle", "HorovodInternalError", "allgather", "allgather_async",
           "allreduce", "allreduce_async", "broadcast", "broadcast_async",
           "grouped_allreduce", "poll", "synchronize"]
