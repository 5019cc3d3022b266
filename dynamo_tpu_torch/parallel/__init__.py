"""Parallelism of the port: the five-axis mesh and its collectives
(mesh.py), the group bootstrap (multihost.py), the leader/follower
descriptor plane (spmd.py), pipeline stages (pipeline.py) and ring
attention over the sequence ranks (ring.py). One process drives one card;
a group of N is N processes, rank 0 the leader."""

from dynamo_tpu_torch.parallel.mesh import make_mesh

__all__ = ["make_mesh"]
