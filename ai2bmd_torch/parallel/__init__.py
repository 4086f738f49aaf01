"""Replica ensembles (``ai2bmd_tpu/parallel``); one card so far."""

from ai2bmd_torch.parallel.sharding import ReplicaEnsemble, replica_generators

__all__ = ["ReplicaEnsemble", "replica_generators"]
