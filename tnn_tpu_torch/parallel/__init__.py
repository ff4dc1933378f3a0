"""Parallel training on a mesh of devices in one process
(``tnn_tpu.parallel``): the mesh and its collectives, the partitioner,
data parallelism with FSDP, and the three pipelines. Tensor, sequence and
expert parallelism are not ported yet (ROADMAP.md item 11.4)."""
from . import data_parallel, mesh, partitioner, pipeline
from .data_parallel import (fsdp_spec_tree, make_dp_train_step,
                            place_by_specs, shard_params_fsdp)
from .mesh import (AXES, Mesh, axis_size, data_mesh, local_mesh_info,
                   make_mesh)
from .partitioner import (SeqPartition, balanced_partitions, layer_flops,
                          partition_model, proportional_partitions, split)
from .pipeline import (HeteroPipeline, StagePipeline,
                       make_pipeline_eval_step, make_pipeline_train_step,
                       spmd_pipeline, spmd_pipeline_interleaved,
                       stack_stage_params)

__all__ = [
    "data_parallel", "mesh", "partitioner", "pipeline",
    "fsdp_spec_tree", "make_dp_train_step", "place_by_specs",
    "shard_params_fsdp", "AXES", "Mesh", "axis_size", "data_mesh",
    "local_mesh_info", "make_mesh", "SeqPartition", "balanced_partitions",
    "layer_flops", "partition_model", "proportional_partitions", "split",
    "HeteroPipeline", "StagePipeline", "make_pipeline_eval_step",
    "make_pipeline_train_step", "spmd_pipeline",
    "spmd_pipeline_interleaved", "stack_stage_params",
]
