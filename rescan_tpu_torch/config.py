"""Centralized numerical constants of the Rescan pipeline.

Every scientific constant of the reference implementation, collected in one
place (the reference hard-codes these across ``*_init_opts`` functions and
inline literals; see SURVEY.md §7.4 for the full citation list).

Reference citations use ``file:line`` into the reference C++ sources.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# ---------------------------------------------------------------------------
# Point-cloud LoD pyramid (lib/rs/rs_pointcloud.h:54,145)
# ---------------------------------------------------------------------------
N_LEVELS = 5
LEVEL_VOXEL_SIZES: Tuple[float, ...] = (0.005, 0.01, 0.02, 0.04, 0.08)
# search grid cell radius used for every per-level grid (rs_pointcloud.h:862)
SEARCH_GRID_RADIUS = 0.05
# mesh resampling density: 0.5 * 12800 samples per m^2 (rs_pointcloud.h:1157-1158)
RESAMPLE_SAMPLES_PER_SQM = 12800.0
RESAMPLE_DENSITY_FACTOR = 0.5
# fixed seeds (rs_pointcloud.h:1135, :428)
RESAMPLE_SEED_BARYCENTRIC = 12346
RESAMPLE_SEED_FACE_DIST = 64321
MERGE_SHUFFLE_SEED = 12346

# ---------------------------------------------------------------------------
# Pose proposal grid search (apps/pose_proposal/pose_proposal.cpp:24-34,93-167)
# ---------------------------------------------------------------------------
GRID_SEARCH_SPACING = 0.10
GRID_SEARCH_N_ANGLES = 10          # angle delta = 2*pi/10 (pose_proposal.cpp:28)
GRID_SEARCH_MAX_NEIGH_RADIUS = 0.25
SCORE_SEARCH_RADII: Tuple[float, ...] = (0.05, 0.1, 0.15, 0.2, 0.25)  # per search lvl (:98)
SCORE_MAX_ANGLE_DEG = 35.0         # (:99)
SCORE_ALPHA = 0.05                 # normal-compat weight (:102)
SCORE_NORMAL_SIGMA = 0.5           # exp(-ang^2/(2*0.5^2)) (:149)
SCORE_SEARCH_LVL = 1               # scene grid level used for scoring (:178,:263)
SCORE_MAX_N_NEIGH = 64             # (:179,:264)
# score thresholds per query level (pose_proposal.cpp:160-168)
SCORE_THRESHOLDS = {4: 0.25, 3: 0.35, 2: 0.40, 1: 0.50, 0: 0.50}
# coarse-to-fine: levels 4,3,2 (pose_proposal.cpp:337)
GRID_SEARCH_LEVELS: Tuple[int, ...] = (4, 3, 2)
# NMS (apps/pose_proposal/main.cpp:160, pose_proposal.cpp:419-422)
NMS_DIST_THRESHOLD = 0.2
NMS_OVERLAP_THRESHOLD = 0.5
NMS_OVERLAP_VOXEL = 0.1
NMS_MIN_SCORE = 0.01
# prior-arrangement poses get this score (apps/pose_proposal/main.cpp:170)
PRIOR_POSE_SCORE = 10.0
# ICP refinement of proposals (apps/pose_proposal/main.cpp:195-197)
REFINE_ICP_LVL = 2
REFINE_ICP_MAX_DIST = 0.10
REFINE_ICP_MAX_ANGLE_DEG = 60.0
REFINE_SCORE_QUERY_LVL = 1

# ---------------------------------------------------------------------------
# ICP (lib/rs/icp.h:416-500)
# ---------------------------------------------------------------------------
ICP_MAX_ITER = 100
ICP_CONVERGE_DELTA = 1e-5
ICP_CONVERGE_MIN_ITER = 5          # "i > 5" gate (icp.h:489)
ICP_DIST_ANNEAL = 0.95             # max_dist *= 0.95 per iter (icp.h:493)
ICP_DIST_FLOOR = 0.05
ICP_MAX_NN = 16                    # correspondence candidates (icp.h:330)
ICP_OUTLIER_SIGMA = 2.5            # 2.5 sigma rejection (icp.h:393-401)

# ---------------------------------------------------------------------------
# Arrangement optimization (apps/segment_transfer/arrangement_optimization.cpp)
# ---------------------------------------------------------------------------
# energy weights: order (scncov, geom, isect, hyster) (:47-55)
ENERGY_WEIGHTS_GREEDY = (2.0, 0.3, 1.0, 1.8)
ENERGY_WEIGHTS_SA = (1.8, 0.5, 1.0, 3.0)
# SA action likelihoods: (add, remove, replace, swap, move) (:57-61)
SA_ACTION_LIKELIHOODS = (0.01, 0.01, 0.01, 1.0, 0.5)
SA_N_ITER = 25000                  # (:45)
SA_SEED = 12346                    # (:796)
SA_INIT_TEMP = 0.01                # (:814)
SA_MIN_TEMP = 0.0001               # (:813)
SA_RESTART_PROB = 0.01             # (:815)
N_PAST_STEPS = 5                   # hysteresis window (:44)
# intersection term: mahalanobis scale (:255 / :244)
ISECT_MAHALANOBIS_SCALE = 0.39
# hysteresis sigma(volume) = max(a*exp(-b*v)+c, 0.1) (:107-114)
HYSTER_SIGMA_A = 8.45747072
HYSTER_SIGMA_B = 1.10715163
HYSTER_SIGMA_C = 0.05781275
HYSTER_SIGMA_MIN = 0.1
HYSTER_DECAY_A = -0.05             # score *= (a*past_idx + b) (:134-135,164)
HYSTER_DECAY_B = 1.05
HYSTER_BASE_SCALE = 0.6            # distance score scaled by 0.6 (:163)
HYSTER_EXISTED_BONUS = 0.4         # (:188)
HYSTER_NOVEL_BONUS = 0.375         # (:189)
HYSTER_MISMATCH_PENALTY = -0.25    # (:185)
HYSTER_DUPLICATE_PENALTY = 5.0     # score -= n_dup*5 (:214)
# energy voxel grids (apps/segment_transfer/main.cpp:323-327)
ENERGY_GRID_VOXEL = 0.05
SALIENCY_GRID_VOXEL = 0.15
SCENE_RASTERIZE_QUALITY_THRESHOLD = 0.5   # (main.cpp:339)
SCENE_RASTERIZE_LVL = 2                   # (arrangement_optimization.cpp:1069)
ARRANGEMENT_RASTERIZE_LVL = 2             # (:1088)
SALIENCY_RASTERIZE_LVL = 2                # (:1113)
# greedy/SA replace action: positional gate (:753)
REPLACE_DIST_THRESHOLD = 0.35
# swap action distance threshold (:560)
SWAP_DIST_THRESHOLD = 0.75
# refine-to-scene ICP after optimization (rs_database.h:222-229)
SCENE_REFINE_ICP_LVL = 2
SCENE_REFINE_ICP_MAX_DIST = 0.075
SCENE_REFINE_ICP_MAX_ANGLE_DEG = 50.0

# ---------------------------------------------------------------------------
# Plane detection / classification (lib/rs/rs_pointcloud_filters.cpp:493-614)
# ---------------------------------------------------------------------------
PLANE_DETECT_LVL = 2
PLANE_DOT_THRESHOLD = 0.8
PLANE_DIST_THRESHOLD = 0.033
PLANE_WALL_COUNT_THRESHOLD = 250
PLANE_FLOOR_RANSAC_ITER = 2500
PLANE_WALL_RANSAC_ITER = 5000
PLANE_RANSAC_SEED = 12346
PLANE_INLIER_LVL = 0
PLANE_INLIER_DIST = 0.05
PLANE_CC_RADIUS = 0.05             # connected-components kNN radius (:343)
PLANE_CC_MAX_NN = 8
# classification (rs_pointcloud_filters.cpp:572-576)
PLANE_CLASSIFY_INLIER_THRESHOLD = 2000
PLANE_CLASSIFY_DOT = 0.7
PLANE_CLASSIFY_HEIGHT = 0.9
PLANE_CLASSIFY_SALIENCY = 0.9
# relabel (rs_pointcloud_filters.cpp:623,634-637)
RELABEL_LVL = 1
RELABEL_DOT = 0.8
RELABEL_DIST = 0.05

# ---------------------------------------------------------------------------
# Label transfer / smoothing (lib/rs/rs_pointcloud_filters.cpp:780-989)
# ---------------------------------------------------------------------------
LABEL_LVL = 1                      # RSPF_POINTCLOUD_LEVEL (:21)
LABEL_TRANSFER_RADIUS = 0.05       # (apps/segment_transfer/main.cpp:389)
LABEL_TRANSFER_MAX_ANGLE_DEG = 70.0
LABEL_TRANSFER_STATIC_RADIUS_SCALE = 1.5   # (:845)
MAX_INSTANCES = 1024               # RSPF_MAX_INSTANCES (:20)
SMOOTH_RADIUS = 0.05               # (:894)
SMOOTH_MAX_NN = 8                  # (:921)
SMOOTH_DIST_EXP = 15.0
SMOOTH_ANGLE_EXP = 16.0
SMOOTH_COST_DYNAMIC = 30           # (:931)
SMOOTH_COST_STATIC = 15
SMOOTH_COST_UNLABELLED = 1
SMOOTH_EDGE_COST = 10              # (:942)
SMOOTH_N_SWEEPS = 2                # gc->swap(2) (:968)

# ---------------------------------------------------------------------------
# Database augmentation (apps/segment_transfer/database_update.cpp:65-67)
# ---------------------------------------------------------------------------
AUGMENT_ICP_MAX_DIST = 0.05
AUGMENT_ICP_MAX_ANGLE_DEG = 10.0

# ---------------------------------------------------------------------------
# Static-class predicate (lib/rs/rs_database.h:257-288)
# ---------------------------------------------------------------------------
STATIC_CLASS_NAMES = (
    "wall", "floor", "ceiling", "door", "window", "picture", "counter",
    "cabinet", "bookshelf", "shelves", "unlabelled", "other",
)

# ---------------------------------------------------------------------------
# Voxel intersection grids (lib/rs/intersect.h)
# ---------------------------------------------------------------------------
ISECT_FAT_FACTOR = 0.3             # bbox fattening (intersect.h:61)
ISECT_BBOX_LVL = 3                 # transformed bbox level (intersect.h:114)
ISECT_RASTER_LVL = 1               # boundary rasterization level (:181,:215)

# ---------------------------------------------------------------------------
# Evaluation (scripts/evaluate_semantic_instance.py:62-64)
# ---------------------------------------------------------------------------
EVAL_OVERLAPS = tuple([0.5 + 0.05 * i for i in range(9)] + [0.25])
EVAL_MIN_REGION_SIZE = 100
# instance encoding: 1000*class + inst (apps/create_eval_files/main.cpp:152-153)
EVAL_INSTANCE_ENCODING = 1000


@dataclasses.dataclass
class ArrangementOpts:
    """Runtime-configurable knobs of segment_transfer, mirroring the
    reference CLI surface (apps/segment_transfer/main.cpp:213-243)."""

    lower_idx: int = 0
    upper_idx: int = 10
    n_sa_iter: int = SA_N_ITER
    n_past_steps: int = N_PAST_STEPS
    energy_weights_greedy: Tuple[float, float, float, float] = ENERGY_WEIGHTS_GREEDY
    energy_weights_sa: Tuple[float, float, float, float] = ENERGY_WEIGHTS_SA
    sa_action_likelihoods: Tuple[float, ...] = SA_ACTION_LIKELIHOODS
    just_greedy_initialization: bool = False
    just_simulated_annealing: bool = False
    # arrangement blob resume surface (apps/segment_transfer/main.cpp:81-141)
    save_arrangement_filename: "str | None" = None
    load_arrangement_filename: "str | None" = None
