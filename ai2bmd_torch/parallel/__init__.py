"""Replica ensembles and fragment sharding over a dp x mp mesh of ranks
(``ai2bmd_tpu/parallel``): vacuum fragment mode and solvated QM/MM, on one
card or over ``torch.distributed`` (one rank a card; ``parallel.launch``
starts the world)."""

from ai2bmd_torch.parallel.device_strategy import mesh_for_strategy, strategy_shape
from ai2bmd_torch.parallel.mesh import make_mesh, mesh_layout
from ai2bmd_torch.parallel.multislice import (assert_mp_slice_local, detect_slices,
                                              hybrid_layout, make_hybrid_mesh)
from ai2bmd_torch.parallel.sharding import (EnsembleSimulation, ReplicaBlock, ReplicaEnsemble,
                                            ShardedPotential, SolvatedReplicaEnsemble,
                                            bucket_shard_order, replica_generators)

__all__ = ["EnsembleSimulation", "ReplicaBlock", "ReplicaEnsemble", "ShardedPotential",
           "SolvatedReplicaEnsemble", "assert_mp_slice_local", "bucket_shard_order",
           "detect_slices", "hybrid_layout", "make_hybrid_mesh", "make_mesh",
           "mesh_for_strategy", "mesh_layout", "replica_generators", "strategy_shape"]
