"""The sharded engines on ``torch.distributed``, one process per device:
the grid (``sharded_grid``), tile (``sharded_tiles``) and indexed
(``sharded_ba``) solves with their point rows split over the ranks of a
process group, the multi-host grid solve and the group/mesh helpers
(``multihost``), and a one-step dry run of each (``dryrun``)."""

from deeparc_tpu_torch.parallel.sharded_ba import (
    ShardedScene,
    make_mesh,
    shard_scene,
    solve_ba_sharded,
)

__all__ = ["ShardedScene", "make_mesh", "shard_scene", "solve_ba_sharded"]
