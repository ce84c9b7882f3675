"""Parallel training of the port: meshes, the axis collectives, data,
tensor, sequence, pipeline and expert parallelism, ZeRO-1, and the train
steps (``parallel.train``)."""

from .mesh import MeshSpec, axis_kinds, create_mesh, dcn_axes, ici_axes
from .collectives import (all_gather, all_to_all, axis_index, axis_size,
                          cross_slice_bytes, hierarchical_psum,
                          hierarchical_psum_tree, ppermute, psum,
                          psum_scatter, ring_shift)
from .data_parallel import allreduce_gradients, shard_batch
from .pipeline import (PipelineSchedule, pipeline_apply,
                       pipeline_value_and_grad, schedule_info)
from .zero import Zero1Optimizer, zero1_init, zero1_state_specs

__all__ = [
    "MeshSpec", "create_mesh", "axis_kinds", "dcn_axes", "ici_axes",
    "psum", "all_gather", "ppermute", "all_to_all", "psum_scatter",
    "axis_index", "axis_size", "ring_shift",
    "hierarchical_psum", "hierarchical_psum_tree", "cross_slice_bytes",
    "shard_batch", "allreduce_gradients",
    "PipelineSchedule", "pipeline_apply", "pipeline_value_and_grad",
    "schedule_info",
    "Zero1Optimizer", "zero1_init", "zero1_state_specs",
]
