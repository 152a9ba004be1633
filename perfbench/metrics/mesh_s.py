"""mesh_s: host seconds of joining the world
(``launch/mesh.py:join_world``) and building the mesh with its groups
(``core/mesh.py:make_mesh``), on the harness's clock, the slowest
rank's.  NCCL's communicators are made lazily at the first collective,
in the plan's first call, and count in ``plan_s``.  Layer: Mesh launch.  Moves
``setup_s``.  Nothing to read on a meshless cell."""

COMBINE = "max"


def read(ctx):
    return ctx.mesh_s
