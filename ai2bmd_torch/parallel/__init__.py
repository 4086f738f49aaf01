"""Replica ensembles (``ai2bmd_tpu/parallel``) on one card: vacuum fragment
mode and solvated QM/MM."""

from ai2bmd_torch.parallel.sharding import (ReplicaEnsemble, SolvatedReplicaEnsemble,
                                            replica_generators)

__all__ = ["ReplicaEnsemble", "SolvatedReplicaEnsemble", "replica_generators"]
