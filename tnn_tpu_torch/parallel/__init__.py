"""Parallel training on a mesh of devices (``tnn_tpu.parallel``): the
mesh and its collectives, the process group a mesh may span
(``process_group``, ``jax.distributed``'s counterpart), the partitioner,
data, tensor, sequence and expert parallelism with FSDP
(``make_dp_train_step``), ring and Ulysses attention, and the three
pipelines."""
from . import (data_parallel, mesh, partitioner, pipeline, process_group,
               ring_attention, tensor_parallel, ulysses)
from .data_parallel import (fsdp_spec_tree, make_dp_train_step,
                            place_by_specs, shard_params_fsdp)
from .mesh import (AXES, Mesh, axis_size, batch_sharding, data_mesh,
                   local_mesh_info, make_mesh, replicated)
from .partitioner import (SeqPartition, balanced_partitions, layer_flops,
                          partition_model, proportional_partitions, split)
from .pipeline import (HeteroPipeline, StagePipeline,
                       make_pipeline_eval_step, make_pipeline_train_step,
                       spmd_pipeline, spmd_pipeline_interleaved,
                       stack_stage_params)
from .ring_attention import ring_attention
from .tensor_parallel import DEFAULT_TP_RULES, shard_params_tp, spec_tree
from .ulysses import ulysses_attention

__all__ = [
    "data_parallel", "mesh", "partitioner", "pipeline", "process_group",
    "ring_attention", "tensor_parallel", "ulysses",
    "fsdp_spec_tree", "make_dp_train_step", "place_by_specs",
    "shard_params_fsdp", "AXES", "Mesh", "axis_size", "batch_sharding",
    "data_mesh", "local_mesh_info", "make_mesh", "replicated",
    "SeqPartition", "balanced_partitions", "layer_flops", "partition_model",
    "proportional_partitions", "split",
    "HeteroPipeline", "StagePipeline", "make_pipeline_eval_step",
    "make_pipeline_train_step", "spmd_pipeline",
    "spmd_pipeline_interleaved", "stack_stage_params",
    "ulysses_attention", "DEFAULT_TP_RULES", "shard_params_tp",
    "spec_tree",
]
