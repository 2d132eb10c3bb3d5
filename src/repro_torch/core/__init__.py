"""cmnnc core: the paper's compiler + CM-accelerator simulator.

Port copy of ``repro.core``: the same code, with every import inside
``repro_torch``; ``tests/test_torch_*.py`` hold the two equal.
"""

from .compiler import (CompileValidationError, TenantPlacement,
                       compile_model, place_tenants, serialize_config,
                       validate_program)
from .compute_plane import (ComputeDescriptor, ComputePlane,
                            DynMatmulDescriptor, NoisyPlane, NumpyPlane,
                            ReferencePlane, TorchPlane, dequantize_int8,
                            make_descriptor, resolve_plane)
from .graph import (Graph, build_fig2_graph, build_lenet_like,
                    build_resnet_block_chain, build_tiny_transformer,
                    execute_reference, from_reference_graph)
from .hwspec import (ChipMesh, ChipSpec, CoreSpec, LinkSpec, make_chip,
                     make_mesh, subchip, submesh)
from .lowering import InterChipStream, LcuDep
from .mapping import MappingError, map_partitions, map_partitions_mesh
from .partition import (PartitionError, chip_cuts_of, cut_bytes,
                        cut_neighbors, partition_chips, partition_graph,
                        plan_replication, replicable_stages,
                        replicate_partitions)
from .poly import (HAVE_ISL, FrontierTable, compile_frontier_table,
                   frontier_cache_clear, frontier_cache_enable,
                   frontier_cache_stats)
from .simulator import (DeadlockError, LinkStats, RawViolation, SimStats,
                        Simulator)

__all__ = [
    "Graph", "build_fig2_graph", "build_lenet_like",
    "build_resnet_block_chain", "build_tiny_transformer",
    "execute_reference", "from_reference_graph",
    "ChipMesh", "ChipSpec", "CoreSpec", "LinkSpec", "make_chip", "make_mesh",
    "subchip", "submesh",
    "InterChipStream",
    "MappingError", "map_partitions", "map_partitions_mesh",
    "PartitionError", "chip_cuts_of", "cut_bytes", "cut_neighbors",
    "partition_chips", "partition_graph", "plan_replication",
    "replicable_stages", "replicate_partitions", "LcuDep",
    "DeadlockError", "LinkStats", "RawViolation", "SimStats", "Simulator",
    "HAVE_ISL", "FrontierTable", "compile_frontier_table",
    "frontier_cache_clear", "frontier_cache_enable", "frontier_cache_stats",
    "compile_model", "serialize_config", "TenantPlacement", "place_tenants",
    "CompileValidationError", "validate_program",
    "ComputeDescriptor", "ComputePlane", "DynMatmulDescriptor", "NoisyPlane",
    "NumpyPlane", "ReferencePlane", "TorchPlane", "dequantize_int8",
    "make_descriptor", "resolve_plane",
]
