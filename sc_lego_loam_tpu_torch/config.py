"""Typed, hashable configuration of the engine: this package's own copy of
``sc_lego_loam_tpu/config.py`` (same classes, fields and defaults, so the
two packages' configs compare equal field by field).

The reference keeps all of this as compile-time ``extern const`` globals in
``LeGO-LOAM/include/utility.h:55-141`` (sensor presets are commented-out
blocks) and as constants in the ``SCManager`` class body
(``include/Scancontext.h:77-96``).  Here every knob is a frozen dataclass;
the shape-bearing fields (``n_scan``, ``horizon_scan``, pad sizes, Scan
Context shape) fix every tensor shape of the engine.  Some fields are read
by no code of this package (``sc.num_candidates``, ``sc.search_ratio``,
``mapping.sc_input_leaf``, ``cap.sc_cloud_pad`` ...): they stay for that
equality.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass


def _d(**kw):
    return dataclasses.field(default_factory=lambda: kw)


@dataclass(frozen=True)
class LidarConfig:
    """Sensor geometry (reference: utility.h:66-106 presets).

    Angles are in degrees, matching the reference's convention; radians are
    derived properties.
    """

    name: str = "os1-64"
    n_scan: int = 64
    horizon_scan: int = 1024
    ang_res_x: float = 360.0 / 1024
    ang_res_y: float = 33.2 / 63
    ang_bottom: float = 16.6 + 0.1
    ground_scan_ind: int = 15          # utility.h:107
    scan_period: float = 0.1           # utility.h:111
    min_range: float = 1.0             # utility.h:115 sensorMinimumRange
    max_range: float = 120.0           # cull for synthetic / projection sanity
    mount_angle: float = 0.0           # utility.h:116 sensorMountAngle
    # True when the input stream is beam-ordered (point i belongs to pixel
    # (i // horizon, i % horizon)) — the useCloudRing analog
    # (utility.h:64): projection becomes a reshape instead of a scatter.
    # Ouster/Velodyne packets are ordered;
    # set False only for genuinely unordered clouds.
    ordered: bool = False

    @property
    def ang_res_x_rad(self) -> float:
        return math.radians(self.ang_res_x)

    @property
    def ang_res_y_rad(self) -> float:
        return math.radians(self.ang_res_y)

    @property
    def max_points(self) -> int:
        return self.n_scan * self.horizon_scan


# Sensor presets mirroring utility.h:66-106.
OS1_64 = LidarConfig()
VLP_16 = LidarConfig(
    name="vlp-16", n_scan=16, horizon_scan=1800, ang_res_x=0.2,
    ang_res_y=2.0, ang_bottom=15.0 + 0.1, ground_scan_ind=7,
)
HDL_32E = LidarConfig(
    name="hdl-32e", n_scan=32, horizon_scan=1800, ang_res_x=360.0 / 1800,
    ang_res_y=41.33 / 31, ang_bottom=30.67, ground_scan_ind=20,
)
OS1_16 = LidarConfig(
    name="os1-16", n_scan=16, horizon_scan=1024, ang_res_x=360.0 / 1024,
    ang_res_y=33.2 / 15, ang_bottom=16.6 + 0.1, ground_scan_ind=7,
)
VLS_128 = LidarConfig(
    name="vls-128", n_scan=128, horizon_scan=1800, ang_res_x=0.2,
    ang_res_y=0.3, ang_bottom=25.0, ground_scan_ind=10,
)

PRESETS = {c.name: c for c in (OS1_64, VLP_16, HDL_32E, OS1_16, VLS_128)}


@dataclass(frozen=True)
class SegmentationConfig:
    """Ground removal + BFS cluster segmentation (utility.h:117-121)."""

    ground_angle_deg: float = 10.0       # imageProjection.cpp:280-285
    segment_theta_deg: float = 60.0      # utility.h:117 segmentTheta
    valid_point_num: int = 5             # utility.h:118
    valid_line_num: int = 3              # utility.h:119
    min_cluster_size: int = 30           # imageProjection.cpp:440
    ground_keep_stride: int = 5          # imageProjection.cpp:337 (every 5th ground pt)
    outlier_keep_stride: int = 5         # imageProjection.cpp:331 (every 5th outlier)
    # Parallel flood-fill rounds; each round runs 4 directional segmented
    # min-scans (ops/segmentation.py).  A component needs one round per
    # direction ALTERNATION of its worst path.  6 rounds measurably
    # matter on full-size street scenes: a 5-seed figure-8 sweep (loops
    # off) gives mean ATE 0.96 at 6 rounds vs 2.5 at 3 rounds — under-
    # merged wall fragments fail the 30-px rule and starve the feature
    # extractor (the tiny BFS-parity scene converges at 3, which is why
    # the unit test alone was a misleading gate).
    max_label_rounds: int = 6


@dataclass(frozen=True)
class FeatureConfig:
    """Edge/planar feature extraction (utility.h:124-130, fA.cpp:680-784)."""

    sections: int = 6                    # utility.h:126 sectionsTotal
    edge_per_section: int = 2            # utility.h:124 edgeFeatureNum
    edge_less_per_section: int = 20      # fA.cpp:713 (<=20 less-sharp)
    surf_per_section: int = 4            # utility.h:125 surfFeatureNum
    edge_threshold: float = 0.1          # utility.h:127
    surf_threshold: float = 0.1          # utility.h:128
    suppress_halfwidth: int = 5          # fA.cpp:720-732 (+-5 neighbors)
    suppress_col_gap: int = 10           # fA.cpp:721 columnDiff > 10 stops
    occlusion_col_gap: int = 10          # fA.cpp:653
    occlusion_range_gap: float = 0.3     # fA.cpp:655-663
    parallel_beam_ratio: float = 0.02    # fA.cpp:673-675
    less_flat_leaf: float = 0.2          # fA.cpp:225 downSizeFilter 0.2
    # Curvature window: +-5 neighbors in compacted ring order (fA.cpp:623-629).
    curvature_halfwidth: int = 5


@dataclass(frozen=True)
class OdometryConfig:
    """Two-stage 3-DOF scan-to-scan LM (fA.cpp:1270-1478,1666-1695)."""

    # Per-scan pre-de-skew into the scan-END frame with the carried
    # previous twist (pipeline._pre_deskew -> odometry.deskew_with_twist;
    # IMU attitude replaces the prediction when ImuConfig is enabled).
    # True for real spinning-lidar data (points are time-distorted); False
    # for instantaneous clouds (synthetic snapshots).  The solver itself
    # is always rigid — see odometry._apply for why the reference's
    # in-solver s-interpolated de-skew (fA.cpp:860-883) is unstable
    # without an IMU and was deliberately not kept.
    deskew: bool = True
    # Joint 6-DOF solve over corner+surf residuals together instead of the
    # reference's two-stage 3-DOF split (fA.cpp:1270-1478).  The split is a
    # CPU-era economy (two 3x3 solves instead of one 6x6) that relies on
    # small per-scan motion; the joint solve lets ground planes constrain
    # roll/pitch/z WHILE corners constrain yaw/x/y, which converges under
    # much larger per-scan rotation (fast-turn robustness).
    joint_6dof: bool = True
    # Query with the DENSE feature sets (less_sharp / less_flat) instead of
    # the reference's sparse picks (2 sharp + 4 flat per section,
    # fA.cpp:702-769).  The reference restricts queries to bound kd-tree
    # lookups on a CPU; batched brute-force NN makes the dense query set
    # cheap, and ~10x more correspondences make spurious minima of the
    # re-associated robust cost far less likely (identifiability).
    dense_queries: bool = True
    # Static caps on the dense query sets (strided subsample of the padded
    # banks).  ~2k queries already give ~100x the reference's constraint
    # count; capping keeps the (Q x T) NN distance matrices of the
    # odometry loop small.
    query_corner_cap: int = 2048
    query_surf_cap: int = 2048
    # Minimum valid correspondences (corner+surf) for the joint solve to
    # trust its result over the constant-velocity prior.
    min_total_corres: int = 20
    # The reference runs 25 tiny fixed-scale steps per stage
    # (fA.cpp:1671,1684); full-Newton trust-region steps converge in far
    # fewer (figure-8 ATE is iteration-insensitive from 8 up: 0.42-0.54
    # across {8,12,25} x {re 1,2} — measured noise band).
    max_iterations: int = 12
    # Correspondence re-search cadence: the reference re-searches every 5th
    # iteration to amortize kd-tree cost (fA.cpp:1052,1163).  Each research
    # is the dominant odometry cost.  Every-2nd (6 researches in the
    # 12-iter budget) is the accuracy-safe setting; a seed sweep of the
    # figure-8 is the gate for relaxing it.
    research_every: int = 2
    nearest_sq_dist: float = 25.0        # utility.h:129 nearestFeatureSearchSqDist
    near_ring_span: float = 2.5          # fA.cpp:1082,1190 (ring window)
    robust_after_iter: int = 5           # fA.cpp:1137,1251
    robust_slope: float = 1.8            # fA.cpp:1138 s = 1 - 1.8|d|
    robust_min_weight: float = 0.1       # fA.cpp:1142,1256 (s <= 0.1 dropped)
    eig_threshold: float = 10.0          # fA.cpp:1338 (degeneracy)
    delta_rot_deg: float = 0.1           # fA.cpp:1367-1376 convergence
    delta_trans_cm: float = 0.1
    min_feature_points: int = 10         # fA.cpp:1668 (sharp corners)
    min_surf_points: int = 100           # fA.cpp:1677 (flat surfs)
    lm_step_scale: float = 0.05          # fA.cpp:1322 (B = -0.05 * d)
    # Per-iteration trust region.  The reference's 0.05-scaled GN steps
    # (fA.cpp:1322) creep and cannot jump basins; a full Newton step along
    # a weakly-constrained direction (translation eigenvalues are ~1e3x
    # smaller than rotation ones) can teleport meters in one iteration,
    # where per-iteration re-association + the hard robust cutoff then
    # lock in a spurious minimum.  Clamping the step keeps full-Newton
    # convergence speed near the optimum while bounding basin jumps.
    max_step_rot: float = 0.1            # rad per accepted iteration
    max_step_trans: float = 0.5          # m per accepted iteration
    # Per-SCAN trust tube around the motion prior: the solution may not
    # leave ||rot|| <= max_rot_from_prior, ||trans|| <= max_trans_from_
    # prior of the initial guess.  The reference's 0.05-scaled creeping
    # steps (fA.cpp:1322) enforce this implicitly — they cannot jump
    # basins; our full-Newton steps CAN, and in rotationally
    # self-similar scenes (pillar rows) the re-associated robust cost has
    # aliased minima ~25 deg away that a jump then locks in for several
    # scans (measured: seed-12 figure-8, scans 206-215, ~25 deg/scan yaw
    # error burst -> 12.5 m ATE; residual 7-13 deg jumps at a 0.26 tube).
    # 0.09 rad/scan DEVIATION FROM THE PRIOR = a 52 deg/s/scan rate
    # change at 10 Hz — an order of magnitude above the bench
    # trajectories' true deviation-from-constant-velocity (<0.7 deg/scan)
    # and any wheeled-vehicle dynamics, and below the observed aliasing
    # jumps.  Platforms with genuinely aggressive rate changes should
    # enable the IMU prior (ImuConfig), as the reference intends.
    max_rot_from_prior: float = 0.09
    max_trans_from_prior: float = 2.5


@dataclass(frozen=True)
class MappingConfig:
    """Scan-to-map 6-DOF LM + keyframe logic (mapOptmization.cpp)."""

    # The reference runs 10 LM iterations re-searching 5-NN every one
    # (mO.cpp:1505-1516); with full-Newton trust-region steps the result is
    # iteration-insensitive (figure-8 ATE 0.40-0.51 across {6,8,10} iters x
    # {re 2,3} — measured noise band), and each re-search is the dominant
    # (Q x T) 5-NN cost.
    max_iterations: int = 8
    research_every: int = 3
    keyframe_dist: float = 0.3           # mO.cpp:1531-1538
    process_interval: float = 0.3        # utility.h:109 mappingProcessInterval
    submap_recent_num: int = 50          # utility.h:134 (loop-closure ON path)
    submap_search_radius: float = 50.0   # utility.h:133 (OFF path)
    corner_leaf: float = 0.2             # mO.cpp:262
    surf_leaf: float = 0.3               # mO.cpp:264
    outlier_leaf: float = 0.4            # mO.cpp:265
    sc_input_leaf: float = 0.5           # mO.cpp:263 downSizeFilterScancontext
    keypose_leaf: float = 1.0            # mO.cpp:268 surrounding key poses
    knn: int = 5                         # mO.cpp:1283,1355 (5-NN)
    max_nn_sq_dist: float = 1.0          # mO.cpp:1287,1359
    corner_eig_ratio: float = 3.0        # mO.cpp:1303 (l0 > 3*l1)
    plane_fit_tol: float = 0.2           # mO.cpp:1374
    robust_slope: float = 0.9            # mO.cpp:1332,1384
    robust_min_weight: float = 0.1       # mO.cpp:1335,1387
    eig_threshold: float = 100.0         # mO.cpp:1459
    delta_rot_deg: float = 0.05          # mO.cpp:1495
    delta_trans_cm: float = 0.05
    min_correspondences: int = 50        # mO.cpp:1410
    min_submap_points: int = 100         # mO.cpp:1503 (corner>10 && surf>100)


@dataclass(frozen=True)
class ImuConfig:
    """IMU fusion (reference C7: featureAssociation.cpp:327-619 de-skew,
    :1639-1664 updateInitialGuess prior; mapOptmization.cpp:484-517
    roll/pitch blend).  Off by default: MulRan runs are lidar-only
    (utility.h:91) and the constant-velocity model applies instead."""

    enabled: bool = False
    que_len: int = 200                   # utility.h:113 imuQueLength
    # transformUpdate blends 0.2% of the IMU roll/pitch into the mapped
    # pose (mO.cpp:490-516: 0.998 * transform + 0.002 * imu).
    blend: float = 0.002
    # Use the IMU dead-reckoned motion as the scan-to-scan initial guess
    # instead of the constant-velocity prior (fA.cpp:1639-1664).
    prior: bool = True
    # IMU-based point de-skew before projection (fA.cpp:491-619); the
    # motion-interpolated exp(s*xi) de-skew in the odometry solver still
    # applies on top, as in the reference.
    deskew: bool = True


@dataclass(frozen=True)
class ScanContextConfig:
    """Scan Context descriptor + retrieval (Scancontext.h:77-96)."""

    num_ring: int = 20
    num_sector: int = 60
    max_radius: float = 80.0
    lidar_height: float = 2.0
    # Descriptor input cap (strided subsample).  The reference feeds a
    # 0.5 m-downsampled cloud (mO.cpp:263,1626-1634) as a CPU economy; a
    # stride cap achieves the same cost bound without the voxel pass — a
    # per-bin MAX over >=27 samples/bin is insensitive to 2x subsampling.
    max_input_points: int = 32768
    exclude_recent: int = 50             # NUM_EXCLUDE_RECENT
    num_candidates: int = 10             # NUM_CANDIDATES_FROM_TREE
    search_ratio: float = 0.1            # SEARCH_RATIO
    dist_threshold: float = 0.5          # SC_DIST_THRES


@dataclass(frozen=True)
class LoopClosureConfig:
    """Radius-search + SC loop detection & ICP verification (mO.cpp:829-1110)."""

    enabled: bool = True                 # utility.h:108 loopClosureEnableFlag
    rs_search_radius: float = 20.0       # utility.h:137
    rs_time_gap: float = 30.0            # mO.cpp:868 (>= 30 s)
    history_num: int = 25                # utility.h:138 (+-25 keyframes)
    history_leaf: float = 0.3            # mO.cpp:267 downSizeFilterHistoryKeyFrames
    fitness_threshold: float = 1.5       # utility.h:139
    # Overlap gate BESIDE the reference's mean-square fitness: accepted
    # alignments must also have >= min_inlier_ratio of source points
    # within sqrt(inlier_sq_dist) of the target after ICP.  The reference
    # relies on fitness<1.5 + Cauchy alone (mO.cpp:1020,1071,990-997;
    # README.md:36-38) and measures ~0.69 loop precision on our revisit
    # bench; a mean-square gate passes alignments where easy ground
    # matches drag the average under threshold while the structure
    # misaligns.  Cloverleaf evidence (tools/diag_loops.py): true factors
    # measure 0.91-0.96, genuinely bad alignments 0.39-0.66; 0.85 keeps
    # recall 1.0.  Aliased matches that still pass (0.857-0.872) are
    # caught by the rotation gate below; together precision is 1.0 at
    # recall 1.0 on both bench paths (ACCURACY.md par.3).
    inlier_sq_dist: float = 1.0
    min_inlier_ratio: float = 0.85
    # Orientation-plausibility gate: reject a factor whose implied
    # ROTATION correction vs the current graph exceeds this (rad).  A
    # true loop's rotation residual is the accumulated heading drift
    # (fractions of a degree to a few degrees for lidar odometry); an
    # aliased match between self-similar places implies a structural
    # rotation (cloverleaf measured: true factors < 2 deg, the two
    # surviving false factors ~90 deg petal mismatches at 30/49 m
    # translation error while passing fitness 0.95-1.06 and inliers
    # 0.857-0.872).  Translation residual is NOT gated — large
    # translation drift is exactly what loops exist to fix.
    max_rot_residual: float = 0.35
    icp_max_iterations: int = 15         # converged long before the
    # reference's 100 (mO.cpp:1007) on keyframe-vs-history submaps; each
    # iteration is an (8k x 32k) NN pass, so the budget is the cost knob
    icp_eps: float = 1e-6                # mO.cpp:1009
    cauchy_k: float = 1.0                # mO.cpp:995 Cauchy::Create(1)
    loop_noise_var: float = 0.5          # mO.cpp:991 noiseScore
    # Loop-check cadence: every Nth MAPPING TICK (host-scheduled, like the
    # mapping interval itself).  The reference's 1 Hz loop thread vs its
    # ~3.3 Hz mapping rate (mO.cpp:834, utility.h:109) = every ~3rd tick.
    check_every_ticks: int = 3


@dataclass(frozen=True)
class PoseGraphConfig:
    """Pose-graph optimizer replacing iSAM2 (mO.cpp:241-244,1525-1664)."""

    prior_var: tuple = (1e-6, 1e-6, 1e-6, 1e-8, 1e-8, 1e-6)  # mO.cpp:368-371
    odom_var: tuple = (1e-6, 1e-6, 1e-6, 1e-8, 1e-8, 1e-6)
    max_gn_iterations: int = 20
    damping: float = 1e-6
    # Loop-factor bank capacity.  The Woodbury capacitance solve in
    # posegraph.solve is (6L)^2, so this bounds the per-resolve cost; the
    # reference accumulates one factor per 1 Hz tick while revisiting
    # (mO.cpp:997), so hundreds over a long run.  Overflow policy: the
    # slot index wraps, RING-OVERWRITING the oldest factor
    # (posegraph.add_loop) — count keeps growing so the host can detect
    # and warn (pipeline._check_caps).
    max_loops: int = 256


@dataclass(frozen=True)
class CapacityConfig:
    """Static pad sizes — the shape contract of the whole engine.

    The reference grows std::vectors unboundedly (mO.cpp:88-90); here every
    bank is preallocated with a high-water mask so shapes stay fixed.
    """

    # Keyframe bank capacity.  16384 keyframes at the 0.3 m rule
    # (mO.cpp:1531-1538) covers a ~4.9 km trajectory — full MulRan DCC
    # scale (~5 km); the reference grows std::vectors unboundedly
    # (mO.cpp:88-90).  Memory budget at full-size pads: corner 0.4 GB +
    # surf 1.6 GB + outlier 0.8 GB + masks 0.23 GB + SC descriptors
    # 0.08 GB ~= 3.1 GB of device memory.  Per-tick cost does NOT
    # scale with K (submap gathers 50 recent; retrieval is one matmul
    # over the bank; the pose-graph edge solve is O(K) + log-depth scan).
    # Overflow policy: new keyframes are DROPPED (mapping.insert_keyframe
    # — the map stops growing, odometry/correction continue) with an
    # insert-side kf_dropped counter the host warns on.
    max_keyframes: int = 16384
    # Device-side fused-trajectory ring buffer (one (4,4) pose per scan;
    # fetched once at the end of a run, never per scan).
    max_scans: int = 16384
    # Per-scan feature pads (post extraction / downsample).
    sharp_pad: int = 1024                # <= 2*6*n_scan = 768 for 64 rings
    flat_pad: int = 2048                 # <= 4*6*64 = 1536
    # True per-scan bound is 20 less-sharp/section * 6 sections * 64 rings
    # = 7680 (fA.cpp:713); no downsample shrinks it before compaction
    # (gather_class compacts directly), so anything smaller silently drops
    # the highest rings' tail in dense scenes.
    less_sharp_pad: int = 8192
    less_flat_pad: int = 8192            # less-flat after 0.2 voxel DS
    outlier_pad: int = 4096              # outlier cloud after DS
    # Keyframe-store pads (post mapping-side voxel DS).
    kf_corner_pad: int = 2048
    kf_surf_pad: int = 8192
    kf_outlier_pad: int = 4096
    # Submap pads (union of submap_recent_num keyframes, post voxel DS).
    submap_corner_pad: int = 16384
    submap_surf_pad: int = 65536
    # Loop-closure history submap pad.
    history_pad: int = 32768
    icp_query_pad: int = 8192
    # Scan Context input cloud pad (raw cloud after 0.5 m DS).
    sc_cloud_pad: int = 16384


@dataclass(frozen=True)
class PipelineConfig:
    """Top-level bundle (hashable)."""

    lidar: LidarConfig = OS1_64
    seg: SegmentationConfig = SegmentationConfig()
    feat: FeatureConfig = FeatureConfig()
    odom: OdometryConfig = OdometryConfig()
    mapping: MappingConfig = MappingConfig()
    imu: ImuConfig = ImuConfig()
    sc: ScanContextConfig = ScanContextConfig()
    loop: LoopClosureConfig = LoopClosureConfig()
    posegraph: PoseGraphConfig = PoseGraphConfig()
    cap: CapacityConfig = CapacityConfig()

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


def default_config() -> PipelineConfig:
    return PipelineConfig()


def vlp16_config() -> PipelineConfig:
    """16-beam sparse-LiDAR variant (BASELINE.json config 5)."""
    return PipelineConfig(
        lidar=VLP_16,
        cap=CapacityConfig(
            sharp_pad=256, flat_pad=512, less_sharp_pad=2048,
            less_flat_pad=4096, outlier_pad=2048,
            kf_corner_pad=1024, kf_surf_pad=4096, kf_outlier_pad=2048,
            submap_corner_pad=8192, submap_surf_pad=32768,
            history_pad=16384, icp_query_pad=4096, sc_cloud_pad=8192,
        ),
    )


def synthetic_config() -> PipelineConfig:
    """Full-size config for instantaneous (undistorted) synthetic clouds,
    emitted beam-ordered (ordered=True -> reshape projection)."""
    return PipelineConfig(
        lidar=dataclasses.replace(OS1_64, ordered=True),
        odom=OdometryConfig(deskew=False))


def tiny_test_config() -> PipelineConfig:
    """Small shapes for fast CPU tests (16 x 128 grid); synthetic
    (instantaneous) clouds, so de-skew is off."""
    lidar = LidarConfig(
        name="tiny", n_scan=16, horizon_scan=128, ang_res_x=360.0 / 128,
        ang_res_y=33.2 / 15, ang_bottom=16.7, ground_scan_ind=7,
    )
    return PipelineConfig(
        lidar=lidar,
        # 16-ring grid (8 ground rows, 128 cols): the every-5th ground
        # subsampling plus +-5 pick suppression leaves only ~13 flat
        # features per scan, so scale the 64-ring minimum guards down.
        # Likewise the absolute degeneracy eigen-thresholds (10/100 in the
        # reference) assume hundreds of correspondences; H eigenvalues
        # scale linearly with correspondence count (~1/30 here).
        odom=OdometryConfig(deskew=False, min_surf_points=8,
                            eig_threshold=0.3),
        mapping=MappingConfig(eig_threshold=1.0, min_correspondences=30),
        # Small loop bank: the Woodbury capacitance is (6L)^2 and CPU test
        # time scales with it.
        posegraph=PoseGraphConfig(max_loops=16),
        cap=CapacityConfig(
            max_keyframes=64, max_scans=1024,
            sharp_pad=256, flat_pad=512, less_sharp_pad=1024,
            less_flat_pad=2048, outlier_pad=1024,
            kf_corner_pad=512, kf_surf_pad=2048, kf_outlier_pad=1024,
            submap_corner_pad=4096, submap_surf_pad=8192,
            history_pad=8192, icp_query_pad=2048, sc_cloud_pad=4096,
        ),
    )
