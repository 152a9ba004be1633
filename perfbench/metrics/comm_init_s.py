"""comm_init_s: host seconds in which the port's mesh made its NCCL
groups and communicators, its ``mesh_comm_init_seconds`` counter: the
folded groups' ``dist.new_group`` and the first collective on each
group, where NCCL makes the group's communicator (in the plan's first
call, inside ``plan_s``).  The slowest rank's.  Layer: Mesh launch.
Moves ``setup_s``.  Nothing to read where the program keeps no such
counter or makes no mesh."""

from perfbench.harness.spans import counter

COMBINE = "max"


def read(ctx):
    return counter(ctx, "mesh_comm_init_seconds")
