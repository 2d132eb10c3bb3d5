"""The distributed layer of the port: gradient compression (its int8 round
trip a hand-written pass on the card), ring and hierarchical reductions on
``torch.distributed``, the accumulated train step, and elastic mesh plans.
Port of ``repro.distributed``.

The reference's ``compat.py`` has no counterpart: it is a shim over JAX
releases' two ``shard_map`` APIs, and the port's collectives are
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
