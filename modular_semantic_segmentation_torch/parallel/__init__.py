"""Mesh-based scaling layer: data, tensor, pipeline, expert and spatial
parallelism (counterpart of the JAX package's ``parallel/``), on
``torch.distributed`` ranks started by ``parallel.launch.launch`` (data,
tensor and spatial parallelism) or in one process over a list of devices
(pipeline and expert parallelism)."""

from modular_semantic_segmentation_torch.parallel.mesh import (
    make_mesh, make_multislice_mesh, replicated, batch_sharded,
    spatial_sharded)
from modular_semantic_segmentation_torch.parallel.data_parallel import \
    distribute
from modular_semantic_segmentation_torch.parallel.tensor_parallel import \
    distribute_tp
from modular_semantic_segmentation_torch.parallel.spatial import \
    distribute_spatial
from modular_semantic_segmentation_torch.parallel.pipeline import (
    Pipeline, fcn_inference_pipeline)
from modular_semantic_segmentation_torch.parallel.expert_parallel import \
    dispatch_experts
from modular_semantic_segmentation_torch.parallel.launch import launch

__all__ = ["make_mesh", "make_multislice_mesh", "replicated",
           "batch_sharded", "spatial_sharded", "distribute",
           "distribute_tp", "distribute_spatial", "Pipeline",
           "fcn_inference_pipeline", "dispatch_experts", "launch"]
