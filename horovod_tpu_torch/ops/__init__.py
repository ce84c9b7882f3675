"""Collectives and kernels of the port."""

from .collective import (Handle, HorovodInternalError, allgather,
                         allgather_async, allreduce, allreduce_,
                         allreduce_async, allreduce_async_, broadcast,
                         broadcast_, broadcast_async, broadcast_async_,
                         grouped_allreduce, poll, synchronize,
                         synchronize_many)

__all__ = ["Handle", "HorovodInternalError", "allgather", "allgather_async",
           "allreduce", "allreduce_", "allreduce_async", "allreduce_async_",
           "broadcast", "broadcast_", "broadcast_async", "broadcast_async_",
           "grouped_allreduce", "poll", "synchronize", "synchronize_many"]
