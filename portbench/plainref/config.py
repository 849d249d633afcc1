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
class EngineConfig:
    imports: ImportConfig = dataclasses.field(default_factory=ImportConfig)
    cluster: ClusterConfig = dataclasses.field(default_factory=ClusterConfig)
    filters: FilterConfig = dataclasses.field(default_factory=FilterConfig)
    icp: ICPConfig = dataclasses.field(default_factory=ICPConfig)
    dtype: str = "float32"        # compute dtype; oracles run float64
    backend: str = "auto"         # kernel dispatch: auto | cuda | torch

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)
