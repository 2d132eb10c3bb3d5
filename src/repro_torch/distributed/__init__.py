"""The distributed layer of the port: gradient compression (its int8 round
trip a hand-written pass on the card), ring and hierarchical reductions on
``torch.distributed``, the accumulated train step, elastic mesh plans, and
``comm``: the hops and collectives of the pipeline and of context
parallelism, routed by the process group's backend.  Port of
``repro.distributed``.

The reference's ``compat.py`` has no counterpart: it translates
``shard_map``'s API across JAX releases and records a body's manual axes
for the model's sharding constraints.  The port has neither ``shard_map``
nor such constraints: each rank's part is written out by hand with
``torch.distributed`` calls on a ``DeviceMesh``'s groups, so neither
``shard_map`` nor ``HAS_NATIVE_SHARD_MAP`` is exported.
"""

from .compression import (CompressionSpec, quantize_blockwise,
                          dequantize_blockwise, topk_sparsify,
                          topk_densify, init_error_feedback,
                          compress_with_feedback, hierarchical_psum,
                          hierarchical_psum_sharded)
from .overlap import (ring_all_reduce, ring_all_reduce_sharded,
                      make_accum_train_step)
from .elastic import (plan_mesh, rescale_tree, make_mesh_from_plan,
                      degrade_sequence, ElasticPlan)

__all__ = [
    "CompressionSpec", "quantize_blockwise", "dequantize_blockwise",
    "topk_sparsify", "topk_densify", "init_error_feedback",
    "compress_with_feedback", "hierarchical_psum",
    "hierarchical_psum_sharded",
    "ring_all_reduce", "ring_all_reduce_sharded", "make_accum_train_step",
    "plan_mesh", "rescale_tree", "make_mesh_from_plan", "degrade_sequence",
    "ElasticPlan",
]
