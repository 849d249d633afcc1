"""Engine configuration.

One dataclass capturing the reference's full parameter surface (dialogs +
hardcoded constants), per SURVEY.md §5 "Config/flag system":

- import params     (reference ImportPts.cs:16-20,31-67)
- clustering params (reference Clustering.cs:14-17,78-124)
- distance window   (reference SureDistanceFilter.cs:26-61)
- radius rejection  (reference MCC.cs:65-80)
- match distance    (reference MatchingParams.cs:36-54)
- hardcoded gates   (reference FrmMain.cs:1011,1481; Tools.cs:400,592; ICP.cs:108)

The port's own copy of vtkcloudpoint_tpu/config.py: the same dataclasses,
fields and defaults (tests/test_torch_guards.py holds the two equal), so the
port never imports the JAX package. The port reads ``backend`` as one of
device.BACKENDS ("auto", "cuda", "torch").
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ImportConfig:
    """Scan-import parameters (reference ImportPts.cs:31-67, FrmMain.cs:916-1134)."""

    x_angle: float = 0.0          # boresight motor-x offset (FrmMain.cs:1026)
    y_angle: float = 0.0          # boresight motor-y offset (FrmMain.cs:1027)
    xdir: int = 2                 # X axis source: 1=+tmpy 2=+tmpx 3=-tmpy 4=-tmpx (FrmMain.cs:1031-1046)
    ydir: int = 1                 # Y axis source, same encoding (FrmMain.cs:1047-1060)
    dedup: bool = True            # exact-duplicate removal (FrmMain.cs:1063-1089, typpe 1)
    range_min_exclusive: float = 0.0    # drop Distance == 0 (FrmMain.cs:1011)
    range_max: float = 1000.0           # drop Distance > 1000 (FrmMain.cs:1011)


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """DBSCAN + block partition + fusion (reference Clustering.cs:78-124)."""

    eps: float = 0.06             # neighborhood radius "threhold" (seed value FrmMain.cs:3736)
    min_pts: int = 9              # min neighborhood count incl. self (FrmMain.cs:3736)
    pts_in_cell: int = 200        # first-block size -> cell extents (FrmMain.cs:1253-1258)
    metric: str = "l1_motor"      # l1_motor (DBImproved.cs:14-25) | l2_xyz | signed_sum_xy (DB.cs bug)
    min_cluster_size: int = 3     # clusters <= this are culled to noise (FrmMain.cs:1481)
    merge_threshold: float = 0.1  # centroid-fusion eps (Clustering.cs:127-131)
    merge_min_pts: int = 2        # centroid-fusion minPts (Tools.cs:592)
    # Engine knobs (no reference analog - TPU capacity discipline):
    block_capacity: int = 256     # padded per-block point capacity
    max_clusters: int = 4096      # padded cluster-table capacity
    propagate_max_iters: int = 64 # label-propagation safety bound


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    """Distance window + shape rejection."""

    dis_min: float = 0.0          # range-window lower (SureDistanceFilter.cs:29-43, exclusive)
    dis_max: float = 1000.0       # range-window upper (exclusive, Tools.cs:416-431)
    radius_threshold: float = 1e30   # circumradius rejection (MCC.cs:69-73, FrmMain.cs:1905-1920)
    aspect_threshold: float = 1e30   # min-area-rect aspect rejection (Polygon.cs:685-702, README)
    circle_min_points: int = 4    # circles only for clusters > 3 pts (Tools.cs:400-401)


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    """Registration (reference FrmMain.cs:841-907 native path; ICP.cs managed path)."""

    max_iterations: int = 100     # vtk SetMaximumNumberOfIterations(100) (FrmMain.cs:855)
    tol: float = 1e-4             # |d - pre_d| < e convergence (ICP.cs:108,180)
    start_by_matching_centroids: bool = True  # FrmMain.cs:858
    solver: str = "horn"          # horn (quaternion eig) | kabsch (svd)
    match_distance: float = 0.5   # NN match acceptance threshold (MatchingParams.cs:39-43)
    num_starts: int = 1           # multi-start restarts (tier-3 extension, BASELINE.json)
    ransac_iters: int = 0         # RANSAC init rounds (tier-3 extension)
    ransac_inlier_threshold: float = 0.1


@dataclasses.dataclass(frozen=True)
class SLAMConfig:
    """Multi-scan pose-graph extension (BASELINE.json tier 4/5; no reference analog)."""

    gn_iterations: int = 10
    damping: float = 1e-6
    loop_closure_radius: float = 5.0


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Mesh / sharding layout (replaces reference ThreadPool fan-out, FrmMain.cs:1340-1399)."""

    mesh_axis: str = "blocks"
    # boundary-shell width (multiple of eps) packed into halo buffers
    # (cluster.halo_fusion.halo_buffers shell_eps; >= 1.0 is sound)
    halo_width_eps: float = 1.0
    # max ppermute ring sweeps of the cross-shard id union-find
    # (parallel.sharded._ring_union outer fixpoint bound)
    fixpoint_max_rounds: int = 16

    @staticmethod
    def size_caps(eps: float, density: float, block_cap: int,
                  blocks_per_device: int = 1, noise_frac: float = 0.0,
                  safety: float = 2.0) -> dict:
        """Overflow-free capacity sizing from (eps, point density, block cap).

        Implements the analytic recipe of docs/PARITY.md "Capacity sizing"
        as a function instead of prose (VERDICT r2 weak item 4), for
        uniform-density 2D/3D clouds under the L1/L2 metrics:

        - an eps-ball holds ~2*eps^2*density points (L1 area 2*eps^2; the
          L2 disk pi*eps^2 is strictly smaller, so the bound covers both);
        - a block of ``block_cap`` points has side ~sqrt(block_cap/density),
          so its eps boundary shell holds ~4*eps*sqrt(block_cap*density)
          points -> ``halo_cap``;
        - an eps-sized grid cell holds ~density*eps^2 points -> ``cell_cap``
          (used for both the hier local stage and the grid noise re-cluster);
        - a device owning blocks_per_device blocks spans a region of
          ~blocks_per_device*block_cap points, so its eps skin holds
          ~4*eps*sqrt(blocks_per_device*block_cap*density) points
          -> ``dev_halo_cap``;
        - expected noise per device is noise_frac * blocks_per_device *
          block_cap -> ``noise_capacity`` (0 noise_frac -> minimum slack).

        ``safety`` (>= 1) multiplies every bound to absorb density
        fluctuations and non-square block shapes; results round up to a
        multiple of 8. Overflow counters on a sized run should be asserted
        == 0 (see benchmarks/tier5_sharded.py).
        """
        import math

        if not (eps > 0 and density > 0 and block_cap > 0 and safety >= 1):
            raise ValueError("size_caps needs eps, density, block_cap > 0 "
                             "and safety >= 1")

        def up8(x):
            return max(8, int(math.ceil(x / 8.0)) * 8)

        def cap_or_all(estimate, total):
            # the shell/skin estimates assume eps << region side; once the
            # estimate stops being a small fraction of the region's points
            # that assumption is broken (degenerate small-scale regime), so
            # cap at "every point" -- always sound, never overflows
            est = safety * estimate
            return up8(total if est > total / 4 else est)

        shell = 4.0 * eps * math.sqrt(block_cap * density)
        dev_pts = blocks_per_device * block_cap
        # the skin test flags points whose 3^D cell stencil touches another
        # device's occupied cells -- a band up to 2*eps wide on each side of
        # the boundary, and Morton device boundaries are not straight lines:
        # budget 2x band x 2x perimeter over the naive eps-shell estimate,
        # PLUS a linear allowance: the measured skin outgrows any
        # perimeter ~ sqrt(dev_pts) model as the device footprint grows
        # (Morton-range boundary roughness + two-hash occupancy-filter
        # false positives both scale with the points, not the perimeter).
        # Calibration: the 50M disk run needed ~267k skin slots at
        # dev_pts=6.25M where the perimeter term alone estimated 120.5k
        # (halo_overflow=25,790 at the old safety*sqrt cap, TIER5_r05);
        # the 10M run's 107,792 cap held with this term absent, and the
        # new bound only grows caps, never shrinks them.
        skin = 16.0 * eps * math.sqrt(dev_pts * density) + 0.025 * dev_pts
        cell = density * eps * eps
        # eps-cell occupancy is ~Poisson(cell): cover a 6-sigma fluctuation
        # before the safety multiplier (a 10^5-cell run WILL sample the tail)
        cell_bound = cell + 6.0 * math.sqrt(cell) + 4.0
        noise = noise_frac * dev_pts
        # the cull turns boundary-split cluster FRAGMENTS (runs of <=
        # min_cluster_size points) into extra noise the background
        # noise_frac does not model: ~(min_size + 1) points per block
        # bounds it (measured ~2.5/block at both 1M and 10M disk runs;
        # the un-modeled term overflowed the first 10M attempt by 10,928
        # points across 8 devices)
        cull_noise = 4.0 * blocks_per_device
        noise_capacity = up8(safety * (noise + cull_noise) + 64)
        # distributed noise re-cluster (parallel.noise_shard): the skin is
        # the noise within the ~2*eps boundary band (same 2x-band x
        # 2x-perimeter budget as the halo skin, scaled by noise_frac); a
        # skin buffer can never need more than the noise buffer itself
        # (skin points are a subset of own noise). Roots are bounded by
        # noise points / min_pts <= noise / 2.
        noise_skin = 16.0 * eps * noise_frac * math.sqrt(dev_pts * density)
        return {
            "halo_cap": cap_or_all(shell, block_cap),
            "cell_cap": up8(safety * cell_bound),
            "dev_halo_cap": cap_or_all(skin, dev_pts),
            "noise_capacity": noise_capacity,
            "noise_skin_cap": min(up8(safety * noise_skin + 64),
                                  noise_capacity),
            "noise_root_cap": up8(safety * noise / 2 + 64),
            "ball_points": 2.0 * eps * eps * density,
        }


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    imports: ImportConfig = dataclasses.field(default_factory=ImportConfig)
    cluster: ClusterConfig = dataclasses.field(default_factory=ClusterConfig)
    filters: FilterConfig = dataclasses.field(default_factory=FilterConfig)
    icp: ICPConfig = dataclasses.field(default_factory=ICPConfig)
    slam: SLAMConfig = dataclasses.field(default_factory=SLAMConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    dtype: str = "float32"        # compute dtype; oracles run float64
    backend: str = "auto"         # kernel dispatch: auto | cuda | torch

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)
