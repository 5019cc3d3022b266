"""Parallelism of the port: the tensor-parallel mesh (mesh.py), the group
bootstrap (multihost.py) and the leader/follower descriptor plane
(spmd.py). One process drives one card; a tp group of N is N processes,
rank 0 the leader."""

from dynamo_tpu_torch.parallel.mesh import make_mesh

__all__ = ["make_mesh"]
