"""Configuration dataclasses, mirrored field for field from the JAX package's
``surtr_tpu/config.py`` (one parameter surface for both implementations; a
test pins the mirror with ``dataclasses.fields``). The field comments there
carry the design history; only the meaning is repeated here.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FractureConfig:
    """Runtime fracture parameters (reference: FractureArgs)."""

    # Hull / fitting limits.
    ich_include_point_limit: int = 20
    ach_plane_gap_inverse: float = 2000.0
    refitting_point_limit: int = 4

    seed: int = 46354

    impact_radius: float = 1.0
    radial_mode: bool = True
    partial_fracture: bool = True
    partial_pattern_dist: float = 0.01
    general_pattern_dist: float = 1.0

    initial_decompose_cell_cnt: int = 64
    partial_pattern_cell_cnt: int = 128
    general_pattern_cell_cnt: int = 1024

    target_adder: float = 0.01

    # --- static shape maxima (padding) ---
    max_faces: int = 32          # F: faces per convex polytope
    max_face_verts: int = 16     # S: vertex slots per face loop
    max_pieces: int = 256        # piece capacity after compaction
    max_active_pieces: int = 32  # pieces clipped per fracture event
    voronoi_neighbors: int = 48  # k-nearest seeds whose bisectors clip a cell
    max_mesh_tris: int = 2048    # visual-mesh triangle capacity per compound
    max_piece_tris: int = 512    # visual-mesh triangle capacity per piece
    max_islands: int = 2         # mesh islands detected per fragment
    island_pool: int = 64        # global capacity for secondary islands
    island_label_iters: int = 12 # label-propagation rounds per labeling
    island_voxel_res: int = 6    # island-merge voxel grid resolution per axis
    island_grid_res: int = 64    # prepare-time inside-solid parity grid
                                 # resolution (0 = exact winding)
    exact_face_overlap: bool = True
    voronoi_prefix: int = 16     # two-pass Voronoi clip prefix (0 = one pass)
    mesh_pair_pool: bool | str = "auto"
    exact_caps: bool = True      # exact cut-surface caps (False = caps from
                                 # the refit convex's cut faces)
    cap_faces: int = 16
    cap_edges: int = 48
    cap_crossings: int = 6
    cap_tris: int = 128
    cap_edge_pool: int = 256
    cap_pool: int = 128
    cap_probe_nudge: float = 1e-4
    voronoi_exact_topk: bool = False
                                 # the port always selects neighbours with an
                                 # exact torch.topk; kept for the mirror

    plane_tol: float = 1e-6


@dataclasses.dataclass(frozen=True)
class PhysicsConfig:
    """Rigid-body parameters (reference: PhysX init)."""

    dt: float = 1.0 / 120.0
    gravity: float = -9.81
    density: float = 10.0
    static_friction: float = 0.5
    dynamic_friction: float = 0.5
    restitution: float = 0.1
    ground_y: float = -2.0

    solver_iters: int = 8
    warm_start: bool = False
    solver_substeps: int = 2
    baumgarte: float = 0.2
    contact_slop: float = 1e-3
    bounce_threshold: float = 0.25
    max_neighbors: int = 8
    max_ground_contacts: int = 4
    max_hull_verts: int = 64
    manifold_points: int = 4
    max_edge_dirs: int = 3
    single_piece_bodies: bool = False
    force_pallas_solver: bool = False
    pallas_narrowphase: bool = True
    force_pallas_narrowphase: bool = False
    pallas_broadphase: bool = True
    force_pallas_broadphase: bool = False
    fused_prep: bool = True
    sleep_velocity: float = 0.05
    sleep_frames: int = 30
    wake_speed: float = 0.2
    wake_push_frames: int = 8
    wake_hops: int = 2
    skip_all_asleep: bool = True

    broadphase_block: int = 512
    broadphase: str = "auto"
    broadphase_window: int = 32
    broadphase_bucket_cap: int = 8


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Software-rasterizer parameters."""

    width: int = 512
    height: int = 512
    shadow_size: int = 512
    ambient: float = 0.08
    pcf_taps: int = 3
    fov_deg: float = 45.0
    z_near: float = 0.01
    z_far: float = 500.0
    tile: int = 16
    tris_per_tile: int = 256
    depth_bias: float = 4e-3


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    fracture: FractureConfig = dataclasses.field(default_factory=FractureConfig)
    physics: PhysicsConfig = dataclasses.field(default_factory=PhysicsConfig)
    render: RenderConfig = dataclasses.field(default_factory=RenderConfig)
