"""The sharded clustering run of the Engine session, numpy only: what
chip_smoke.py drives through the port's Engine.cluster_sharded on one GPU
(a one-rank NCCL mesh) and tools/jax_reference_sharded.py through the JAX
package's on a one-device mesh.

The batch is the Engine session's (tools/engine_session.py: import, then
the 10-100 m distance window). Its 450 blobs have sigma 0.0008 in motor
units, so a blob's 2-sigma disk holds ~0.86 x 1,100 points on 8.0e-6:
``density`` 1e8 points per unit motor area, from which
ParallelConfig.size_caps sizes every capacity (cell_cap 3,688, halo_cap
1,024, noise_capacity 13,992, ...). Nearly every point is a halo point
(the blobs fit in a 3 x 3 eps stencil and most straddle two Morton blocks;
the densest halo cell holds 1,534 points). ``skin_dest_cap`` is set: its
default, 2 x 5 x dev_halo_cap slots a destination, is 5M rows at one rank,
where no point has a foreign owner.

MODES are the modes of __graft_entry__.dryrun_multichip on top of the
Engine's defaults (hier halo union, owner skin exchange).

    from tools.sharded_session import SHARDED, MODES
"""
SHARDED = dict(density=1.0e8, skin_dest_cap=64)

MODES = {
    "hier": {},
    "ring": {"halo_mode": "ring"},
    "hier_dist_split": {"noise_recluster": "distributed",
                        "split_programs": True},
    "centroid_merge": {"centroid_merge": True, "merge_eps": 0.01,
                       "merge_min_pts": 2},
}
