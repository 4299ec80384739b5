"""Shapes past the kernels' old limits.

Each kernel wrapper picks its variant with a pure function of shapes
(``_variant``, ``_exact_variant``, ``_sorted_variant``): today's variant for
every shape the main path gives it (PERF.md §6, "Shapes on its path"), a
general one past the old limits, and no shape the plain version takes is
refused; the two limits the JAX package keeps (B6's ``MAX_EXACT_NP``, B12's
``K > 2·window``) stay in the wrappers.

Then the configurations that once raised on the card run through the
port's plain route on the CPU against the JAX package on the CPU:
``physics_step`` of the 27-cube lattice for 8 steps under
``max_neighbors=32`` (B6, B9 and B12 past K = 16), ``max_hull_verts=12``
and ``24`` (B7 at a Vh it had no template for), and ``prepare_fracture``
of the cube at C = 8 under ``max_piece_tris=2048`` (B3 past T = 1024),
``refitting_point_limit=64`` (B2 past 128 faces) and ``max_faces=256,
max_face_verts=32`` (B1 past a CTA's shared memory). The tolerances are
those of tests/test_torch_physics_step.py and tests/test_torch_prepare.py
for the same functions (their docstrings give the reasons); the JAX
prepare runs in an AVX-only child process, as there.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surtr_tpu_torch.ops import clip_cuda, hull_cuda, labels_cuda, soup_clip_cuda
from surtr_tpu_torch.physics import (broadphase_cuda, narrowphase_cuda, pack_cuda, prep_cuda,
                                     solver_cuda)
from surtr_tpu_torch.render import raster_cuda
from torch_threads import bounded_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _variants():
    """name: (variant function of a shape tuple, today's variant name)."""
    return {
        "B1": (lambda s: clip_cuda._variant(*s), "shared"),
        "B2": (lambda s: hull_cuda._variant(*s), "block"),
        "B3": (lambda s: labels_cuda._variant(*s), "block"),
        "B5": (lambda s: pack_cuda._variant(*s), "staged"),
        "B6": (lambda s: broadphase_cuda._exact_variant(*s), "tiled"),
        "B7": (lambda s: narrowphase_cuda._variant(*s), "staged"),
        "B8": (lambda s: prep_cuda._variant(*s), "shared"),
        "B9": (lambda s: solver_cuda._variant(*s), "registers"),
        "B10": (lambda s: soup_clip_cuda._variant(*s), "warp"),
        "B11": (lambda s: raster_cuda._variant(*s), "resident"),
        "B12": (lambda s: broadphase_cuda._sorted_variant(*s), "warp"),
    }


# The main path's shapes (PERF.md §6) in each function's argument order:
# B1 (N, F, S); B2 (B, N, F): the one-set hulls (the cube's 8 points, the
# sphere's 162, the torus's 288, the model scale's 5,000, 13,000 points at
# limit 62); B3 T; B5 (Vh, F, Ne); B6 K; B7 (Vh, K, F, Ne, M);
# B8 (K, M, G); B9 (K, C); B10 S; B11 tiles (the 512² screens: 1,024² and
# more take the global variant past the measured crossover); B12 (K, W).
MAIN_PATH = {
    "B1": [(1024, 26, 16), (1, 26, 16), (512, 32, 16), (1024, 96, 32), (1088, 96, 32),
           (1024, 32, 16)],
    "B2": [(1, 8, 20), (1, 162, 20), (1, 288, 20), (1, 5000, 20), (1, 13000, 2 * 62 + 4)],
    "B3": [(64,), (1,)],
    "B5": [(8, 26, 3), (8, 8, 3), (64, 32, 3), (64, 26, 3)],
    "B6": [(8,), (1,), (16,)],
    "B7": [(8, 8, 26, 3, 4), (8, 8, 8, 3, 4), (64, 8, 32, 3, 4), (64, 8, 26, 3, 4)],
    "B8": [(8, 4, 4), (8, 1, 4)],
    "B9": [(8, 36), (16, 128)],
    "B10": [(8,)],
    "B11": [(128,), (1,), (32,)],
    "B12": [(8, 32), (16, 128), (16, 8), (2, 1)],
}
# A shape past each old limit (a configuration that reaches it, or the
# first value that does where no configuration field names it).
PAST = {
    "B1": [(1024, 256, 32), (16, 1025, 3)],
    "B2": [(128, 6560, 2 * 64 + 4), (1, 162, 129), (2, 45, 132)],
    "B3": [(2048,), (1025,)],
    "B5": [(724, 26, 3), (768, 32, 3)],
    "B6": [(32,), (17,)],
    "B7": [(12, 8, 26, 3, 4), (24, 8, 26, 3, 4), (48, 32, 26, 3, 4), (128, 8, 26, 3, 4),
           (8, 8, 8, 3, 20)],
    "B8": [(64, 32, 4), (32, 64, 4)],
    "B9": [(32, 132), (17, 17), (8, 136)],
    "B10": [(16,), (3,), (40,)],
    "B11": [(32768,), (10240,), (8192,), (512,)],
    "B12": [(32, 32), (8, 256), (17, 128)],
}


@pytest.mark.parametrize("kernel", list(MAIN_PATH))
def test_variant_names_todays_kernel_on_the_main_path(kernel):
    fn, today = _variants()[kernel]
    for shape in MAIN_PATH[kernel]:
        assert fn(shape) == today, (kernel, shape)


@pytest.mark.parametrize("kernel", list(PAST))
def test_variant_takes_shapes_past_the_old_limits(kernel):
    fn, today = _variants()[kernel]
    for shape in PAST[kernel]:
        v = fn(shape)
        assert v != today and isinstance(v, str), (kernel, shape, v)


# Each kernel's general variant, and the shapes its old variant took, as the
# old wrappers checked them (byte counts from the old kernels' layouts):
# (general variant, old limit held).
OLD_LIMITS = {
    "B1": ("cta", lambda N, F, S: F <= 1024 and F * (6 * S + 41) * 4 <= 232448),
    "B2": ("general", lambda B, N, F: F <= 128),
    "B3": ("vertex", lambda T: 1 <= T <= 96),
    "B5": ("direct", lambda Vh, F, Ne: (128 // (16 if max(Vh, F, Ne) <= 16 else 32))
           * (4 * Vh + 5 * F + 26 + 4 * Ne + 9) * 4 <= 48 * 1024),
    "B6": ("general", lambda K: K <= 16),
    "B7": ("general", lambda Vh, K, F, Ne, M: Vh in (8, 16, 32, 64)),
    "B8": ("wide", lambda K, M, G: 4 * (K * (5 + 6 * M) + 21 * K + 19 + 5 * G + K * M + G)
           <= 48 * 1024),
    "B9": ("general", lambda K, C: 1 <= K <= 16 and C <= 128),
    "B10": ("general", lambda S: S == 8),
    "B11": ("global", lambda tiles: (tiles + 1) * 4 <= 40 * 1024),
    "B12": ("list", lambda K, W: K <= 16 and W <= 128),
}


def test_variant_refuses_no_shape():
    """Over a grid of shapes around each old limit, every variant function
    names today's variant or its kernel's general one, never anything else:
    today's wherever the old limit held (B7: only at the Vh it had a
    template for, as records wider than a staged row or rows past a block's
    shared memory go to the general variant too), the general one wherever
    it did not. The wrappers refuse only what the JAX package refuses."""
    fns = _variants()
    grids = {
        "B1": [(n, f, s) for n in (1, 7, 4096) for f in (4, 26, 249, 250, 984, 985, 1024, 1025,
                                                          4096) for s in (3, 8, 32, 64)],
        "B2": [(b, n, f) for b in (1, 2, 1088) for n in (1, 45, 608, 1917, 1918, 2187, 2188,
                                                         13000)
               for f in list(range(4, 1100, 37)) + [44, 128, 129]],
        "B3": [(t,) for t in range(1, 5000, 97)] + [(96,), (97,), (1024,), (1025,)],
        "B5": [(v, f, e) for v in (1, 8, 16, 17, 100, 723, 724, 1000, 4000) for f in (1, 16, 26,
                                                                                      2000)
               for e in (0, 3, 16, 40)],
        "B6": [(k,) for k in range(1, 200, 7)] + [(16,), (17,), (32,), (33,), (64,), (65,)],
        "B7": [(v, k, f, e, m) for v in (1, 3, 8, 12, 16, 32, 64, 65, 300) for k in (1, 8, 40)
               for f in (1, 26, 400) for e in (0, 3) for m in (1, 4, 30)],
        "B8": [(k, m, g) for k in (1, 8, 16, 32, 200) for m in (1, 4, 50) for g in (0, 4, 64)],
        "B9": [(k, c) for k in (0, 1, 16, 17, 200) for c in (1, 128, 129, 5000)],
        "B10": [(s,) for s in range(3, 70)],
        "B11": [(t,) for t in (1, 128, 157, 158, 200, 512, 8192, 10239, 10240, 32768,
                               10 ** 6)],
        "B12": [(k, w) for w in (1, 8, 128, 129, 1000) for k in range(1, 2 * w + 1, 13)]
        + [(16, 128), (17, 128), (16, 129)],
    }
    for kernel, shapes in grids.items():
        fn, today = fns[kernel]
        general, held = OLD_LIMITS[kernel]
        for shape in shapes:
            v = fn(shape)
            if kernel not in ("B1", "B2", "B3", "B5", "B6", "B7", "B9", "B10"):
                assert v in (today, general), (kernel, shape, v)
            if kernel == "B7":     # past the staged kernel the group one where its rows fit
                assert v in (today, "group", general), (kernel, shape, v)
                assert v != today or held(*shape), (kernel, shape, v)
                fits = narrowphase_cuda.group_bytes(*shape) <= narrowphase_cuda.MAX_SMEM - 156
                assert v == today or (v == "group") == fits, (kernel, shape, v)
            elif kernel == "B5":   # past 48 KB the wide one where a piece's CTA fits
                assert v in (today, "wide", general), (kernel, shape, v)
                assert (v == today) == held(*shape), (kernel, shape, v)
                fits = pack_cuda.wide_bytes(*shape) <= pack_cuda.MAX_SMEM
                assert v == today or (v == "wide") == fits, (kernel, shape, v)
            elif kernel == "B10":  # past S = 8 the group one up to a warp's slots
                assert v in (today, "group", general), (kernel, shape, v)
                assert (v == today) == held(*shape), (kernel, shape, v)
                assert (v == "group") == (not held(*shape) and shape[0] <= 32), (kernel, shape)
            elif kernel == "B9":   # past the register kernel the shared one where a row fits
                assert v in (today, "shared", general), (kernel, shape, v)
                assert (v == today) == held(*shape), (kernel, shape, v)
                fits = shape[0] >= 1 and solver_cuda.shared_bytes(*shape, True) <= 232448
                assert v == today or (v == "shared") == fits, (kernel, shape, v)
            elif kernel == "B11":  # the resident kernel up to the measured crossover
                assert (v == today) == (shape[0] <= raster_cuda.RESIDENT_TILES), (kernel, shape)
                assert v != today or held(*shape), (kernel, shape, v)
            elif kernel == "B6":   # past K = 16 the tiled sweep's long lists, up to 64
                assert v in (today, "long", general), (kernel, shape, v)
                assert (v == today) == held(*shape), (kernel, shape, v)
                assert (v == "long") == (16 < shape[0] <= broadphase_cuda.LONG_K), (kernel, shape)
            elif kernel == "B1":   # a CTA a polytope, its vertex buffers on chip or not
                # the shared fold where it holds two polytopes a CTA (measured)
                F, S = shape[1:]
                two = 2 * clip_cuda.poly_bytes(F, S) <= clip_cuda.MAX_SMEM
                assert (v == today) == (held(*shape) and two), (kernel, shape, v)
                past = ("cta" if clip_cuda.cta_bytes(F, S) <= clip_cuda.MAX_SMEM else
                        "cta_scratch" if clip_cuda.cta_aux_bytes(F) <= clip_cuda.MAX_SMEM else
                        "global")
                assert v == today or v == past, (kernel, shape, v)
            elif kernel == "B3":   # vertex ids: the state on chip, or in a scratch
                assert v in (today, general, "vertex_scratch"), (kernel, shape, v)
                assert (v == today) == held(*shape), (kernel, shape, v)
                assert (v == "vertex_scratch") == (
                    labels_cuda.vertex_bytes(*shape) > labels_cuda.MAX_SMEM), (kernel, shape, v)
            elif kernel == "B2":   # up to 128 face slots a block a set or a warp a set
                assert v in (today, "warp_set", general), (kernel, shape, v)
                assert (v != general) == held(*shape), (kernel, shape, v)
                assert (v == "warp_set") == (shape[0] > 1 and held(*shape) and hull_cuda.set_bytes(
                    *shape[1:]) <= hull_cuda.WARP_SET_BYTES), (kernel, shape, v)
            else:
                assert (v == today) == held(*shape), (kernel, shape, v)
    args = [torch.zeros((4, 3)), torch.zeros((4, 3)), torch.ones((4, 3)),
            torch.arange(4), torch.ones(4, dtype=torch.bool)]
    with pytest.raises(ValueError, match="2·window"):
        broadphase_cuda.broadphase_sorted(*args, 5, 2)
    big = broadphase_cuda.MAX_EXACT_NP + 1
    with pytest.raises(ValueError, match="MAX_EXACT_NP|<="):
        broadphase_cuda.broadphase_exact(torch.zeros((big, 3)), torch.zeros((big, 3)),
                                         torch.zeros((big, 3)), torch.zeros(big, dtype=torch.long),
                                         torch.zeros(big, dtype=torch.bool), 8)


def test_b2_variant_takes_the_refit_pools_a_warp_a_set():
    """B2's batched entry: the refit pools (the cube 1k event at limits 8
    and 20, the torus config-1 event and the cube32 impact at 20) on the
    warp-a-set kernel; B = 1 and sets past a warp's shared memory (13,000
    points) on the block kernel, F > 128 on the general one whatever B."""
    for B, N, F in ((1088, 608, 20), (1088, 608, 44), (1088, 512, 44), (320, 896, 44),
                    (9, 45, 44), (8, 200, 20), (2, 2187, 44), (2, 1917, 128)):
        assert hull_cuda._variant(B, N, F) == "warp_set", (B, N, F)
    for B, N, F in ((1, 45, 44), (1, 608, 44), (2, 13000, 44), (2, 2188, 44), (2, 1918, 128)):
        assert hull_cuda._variant(B, N, F) == "block", (B, N, F)
    for B, N, F in ((128, 6560, 132), (8, 200, 132), (1, 162, 132), (1, 5000, 260)):
        assert hull_cuda._variant(B, N, F) == "general", (B, N, F)


def test_b6_and_b11_past_the_old_limits_take_the_redesigned_variants():
    """B6 past K = 16 runs the tiled sweep with lists of 32 or 64 keys up to
    K = 64, the thread-a-piece general variant only past that; B11 at the
    reference's shadow clamps (4096² and 8192², surtr_tpu/config.py:337)
    past the resident kernel's threshold runs the global variant, whose key
    scratch grows with its grid, not with the screen."""
    for K in (17, 24, 32, 33, 48, 64):
        assert broadphase_cuda._exact_variant(K) == "long", K
    for K in (65, 80, 128, 1000):
        assert broadphase_cuda._exact_variant(K) == "general", K
    tiles = lambda n: -(-n // raster_cuda.TH) * -(-n // raster_cuda.TW)   # noqa: E731
    assert tiles(8192) == 32768 and raster_cuda._variant(32768) == "global"
    assert tiles(4096) == 8192 and raster_cuda._variant(8192) == "global"
    # The crossover measured on render_512's shadow maps: the resident kernel
    # at 512² (128 tiles, the frame's screens), the global variant from 640²
    # (200 tiles) on, 1,024² (512 tiles) among them.
    assert raster_cuda._variant(tiles(512)) == "resident"
    assert raster_cuda._variant(tiles(640)) == raster_cuda._variant(tiles(1024)) == "global"
    assert tiles(512) <= raster_cuda.RESIDENT_TILES < tiles(640)
    assert (raster_cuda.RESIDENT_LIMIT + 1) * 4 <= 40 * 1024 < (raster_cuda.RESIDENT_LIMIT + 2) * 4
    slots = raster_cuda.SLOTS_PER_SM * 132
    assert raster_cuda.global_bytes(32768, slots) == 32772 * 4 + slots * (2048 * 8 + 4)
    assert raster_cuda.global_bytes(32768, slots) < 20 * 2 ** 20 < 4096 * (2048 * 8 + 4)
    assert raster_cuda.global_bytes(1, 1) == 16 + 2048 * 8 + 4


def test_b1_and_b3_past_the_old_limits_take_the_redesigned_variants():
    """B1 runs a CTA a polytope wherever the shared fold would hold one
    polytope a CTA (measured faster there at S = 8, 16 and 32) and past it:
    its whole state on chip up to 264 faces at S = 32 (phase 30's F = 256
    prepare), its vertex buffers in a scratch past that (F = 1,025 at S =
    8), the global fold only where even the per-face state passes a CTA (F
    > 2,131). The shared fold keeps every shape of two or more polytopes a
    CTA, the main path's among them (the cube's F = 26-32, the torus's F =
    96 at S = 32). B3 past its measured crossover (T > 96: the torus
    config-1 event's and the cube32 impact's T = 128, the Scenes' 512) runs
    the vertex variant, on chip up to T = 2,454 (``max_mesh_tris``' 2,048
    among them); the block kernel keeps T <= 96 (the cube event's and the
    frame's T = 64)."""
    for N, F, S in ((1024, 26, 16), (1, 88, 16), (1088, 96, 32), (1, 124, 32), (4, 212, 16),
                    (1, 492, 3)):
        assert clip_cuda._variant(N, F, S) == "shared", (N, F, S)
    for N, F, S in ((64, 125, 32), (4, 213, 16), (1, 493, 3), (1, 249, 32), (4, 424, 16),
                    (64, 256, 32), (1, 250, 32), (64, 264, 32), (8, 425, 16), (1, 1024, 3),
                    (800, 1025, 3)):
        assert clip_cuda._variant(N, F, S) == "cta", (N, F, S)
    for N, F, S in ((64, 265, 32), (800, 1025, 8), (1, 2131, 3)):
        assert clip_cuda._variant(N, F, S) == "cta_scratch", (N, F, S)
    for N, F, S in ((1, 2132, 3), (4, 4096, 8)):
        assert clip_cuda._variant(N, F, S) == "global", (N, F, S)
    assert clip_cuda.cta_bytes(264, 32) <= clip_cuda.MAX_SMEM < clip_cuda.cta_bytes(265, 32)
    assert clip_cuda.cta_aux_bytes(2131) <= clip_cuda.MAX_SMEM < clip_cuda.cta_aux_bytes(2132)
    for T in (1, 64, 96):
        assert labels_cuda._variant(T) == "block", T
    for T in (97, 128, 512, 1024, 1025, 2048, 2049, 2454):
        assert labels_cuda._variant(T) == "vertex", T
    for T in (2455, 4096, 10000):
        assert labels_cuda._variant(T) == "vertex_scratch", T
    assert labels_cuda.vertex_bytes(2454) <= labels_cuda.MAX_SMEM < labels_cuda.vertex_bytes(2455)


def test_b8_and_b12_past_the_old_limits_take_the_redesigned_variants():
    """B12 past K = 16 or W = 128 runs the list selection (a warp a sorted
    lane, each lane's candidates in order): at phase 30's shapes, K 32 W
    32, K 8 W 256, K 32 W 1,024 and K 48 W 32; its lists leave shared
    memory only past 232,448 B a warp. B8 past a 48 KB row runs the wide
    variant (a CTA a row, a third of the SM's shared memory at most): at
    phase 30's K 32, M 64 all 32 partners in one pass, 52,496 B; its
    records are read in place only where one partner's record passes that
    room (M > 3,223). The main path keeps "warp" and "shared"."""
    for K, W in ((32, 32), (8, 256), (32, 1024), (48, 32), (17, 8), (2048, 1024)):
        assert broadphase_cuda._sorted_variant(K, W) == "list", (K, W)
    for K, W in ((8, 32), (16, 128), (2, 1)):
        assert broadphase_cuda._sorted_variant(K, W) == "warp", (K, W)
    assert broadphase_cuda.list_bytes(32, 1024) == 8 * (32 * 32 + 32) == 8448
    assert broadphase_cuda.list_bytes(8, 256) == 8 * (32 * 8 + 8)
    assert broadphase_cuda.list_bytes(900, 15000) > broadphase_cuda.MAX_SMEM
    assert broadphase_cuda._sorted_variant(900, 15000) == "list_scratch"
    assert prep_cuda._variant(8, 4, 4) == prep_cuda._variant(8, 1, 4) == "shared"
    assert prep_cuda.row_bytes(32, 64, 4) == 60844 > prep_cuda.STAGE_BYTES
    assert prep_cuda._variant(32, 64, 4) == prep_cuda._variant(64, 32, 4) == "wide"
    assert prep_cuda.wide_partners(32, 64, True) == 32
    assert prep_cuda.wide_bytes(32, 64, True) == 4 * (32 * (389 + 21) + 4) == 52496
    assert prep_cuda.wide_bytes(32, 64, False) == 4 * 32 * 21
    assert prep_cuda.wide_partners(4, 3223, True) == 1 and prep_cuda._variant(4, 3223, 4) == "wide"
    assert prep_cuda.wide_partners(4, 3224, True) == 0
    assert prep_cuda._variant(4, 3224, 4) == "wide_inplace"
    assert prep_cuda.wide_partners(5000, 1, False) < 5000          # passes of partners
    assert prep_cuda.wide_bytes(5000, 1, False) <= prep_cuda.WIDE_ROOM


def test_b7_and_b9_past_the_old_limits_take_the_redesigned_variants():
    """B7 past the staged kernel's shapes runs the group variant (a group of
    G lanes a pair, G from Vh) wherever a block's pair rows fit its shared
    memory: every shape past the old limits, phase 30's Vh 12 and 768 and
    M 64 among them; the thread-a-pair "general" variant only past that
    room. B9 past K = 16 or C = 128 runs the shared variant (a warp a row)
    wherever a row's warm-mode state fits 232,448 B: phase 30's K 32, C
    132 and C 2,052; "general" (the scratch) only past it. The main path
    keeps "staged" and "registers"."""
    room = narrowphase_cuda.MAX_SMEM - 39 * 4
    for shape in PAST["B7"] + [(12, 32, 26, 3, 4), (768, 8, 26, 3, 4), (8, 32, 8, 3, 64),
                               (100, 8, 26, 3, 4), (3, 8, 26, 3, 4)]:
        assert narrowphase_cuda._variant(*shape) == "group", shape
    for shape in MAIN_PATH["B7"]:
        assert narrowphase_cuda._variant(*shape) == "staged", shape
    assert [narrowphase_cuda.group_lanes(v) for v in (1, 6, 7, 8, 12, 13, 24, 48, 64, 96, 97,
                                                      768)] == [
        1, 1, 2, 2, 2, 4, 4, 8, 16, 16, 32, 32]
    for K in (1, 8, 32):   # the last Vh whose rows fit, and the next
        last = max(v for v in range(1200, 2000) if narrowphase_cuda.group_bytes(
            v, K, 26, 3, 4) <= room)
        assert narrowphase_cuda._variant(last, K, 26, 3, 4) == "group", K
        assert narrowphase_cuda._variant(last + 1, K, 26, 3, 4) == "general", K
    for K, C in PAST["B9"] + [(32, 132), (32, 32 * 64 + 4)]:
        assert solver_cuda._variant(K, C) == "shared", (K, C)
    for K, C in MAIN_PATH["B9"]:
        assert solver_cuda._variant(K, C) == "registers", (K, C)
    assert solver_cuda.shared_bytes(32, 2052, True) == 206368
    for K in (1, 32, 64):   # the last C whose row fits, and the next
        last = max(c for c in range(2200, 2400) if solver_cuda.shared_bytes(K, c, True) <= 232448)
        assert solver_cuda._variant(K, last) == "shared", K
        assert solver_cuda._variant(K, last + 1) == "general", K
    assert solver_cuda._variant(0, 5) == "general"


def test_b5_and_b10_past_the_old_limits_take_the_redesigned_variants():
    """B5 past the staged kernel's 48 KB runs the wide variant (a warp a
    piece, the CTA's rows and raw corners in opt-in shared memory): at
    phase 30's Vh 768 and Vh 724, the first past 48 KB at F = 26, Ne = 3;
    its raw corners are read in place past Vh 7,989, and "direct" takes
    only rows past a block's 232,448 B (Vh > 14,482). B10 runs the group
    variant (G threads a lane, a slot each) at 3 <= S <= 32 but 8, phase
    30's S = 16 among them, and the general one past a warp's slots. The
    main path keeps "staged" and "warp"."""
    for shape in ((724, 26, 3), (768, 26, 3), (768, 32, 3), (7989, 26, 3), (7990, 26, 3),
                  (14482, 26, 3), (724, 32, 17)):
        assert pack_cuda._variant(*shape) == "wide", shape
    for shape in ((723, 26, 3), *MAIN_PATH["B5"]):
        assert pack_cuda._variant(*shape) == "staged", shape
    for shape in ((14483, 26, 3), (20000, 8, 0)):
        assert pack_cuda._variant(*shape) == "direct", shape
    assert pack_cuda.wide_stage(7989, 26, 3) and not pack_cuda.wide_stage(7990, 26, 3)
    assert pack_cuda.wide_pieces(768, 26, 3) == pack_cuda.wide_pieces(724, 26, 3) == 3
    assert pack_cuda.wide_pieces(8, 8, 3) == pack_cuda.WIDE_PIECES
    assert pack_cuda.wide_pieces(2667, 26, 3) == 1
    for S in (3, 4, 5, 7, 9, 16, 17, 31, 32):
        assert soup_clip_cuda._variant(S) == "group", S
    assert soup_clip_cuda._variant(8) == "warp"
    for S in (33, 40, 64):
        assert soup_clip_cuda._variant(S) == "general", S
    assert [soup_clip_cuda.group_lanes(S) for S in (3, 4, 5, 7, 9, 16, 17, 32)] == [
        4, 4, 8, 8, 16, 16, 32, 32]


def test_b5_wide_bytes_match_a_hand_counted_layout():
    """The wide CTA at Vh 768, F 26, Ne 3: rows of D = 3,072 + 130 + 26 +
    12 = 3,240 floats, 3 pieces (the most within a third of 232,448 B):
    the packed span 9,720 + 3 floats → 9,724, the AABB span 27 + 3 → 32,
    the raw corners 6,912 + 3 → 6,916, the masks' 2,304 bytes → 576
    floats; one piece in place at Vh 14,482: 58,096 + 3 → 58,100 and 12,
    232,448 B, all a block may take."""
    assert pack_cuda.wide_bytes(768, 26, 3) == 4 * (9724 + 32 + 6916 + 576) == 68992
    assert 4 * (12964 + 40 + 9220 + 768) > pack_cuda.WIDE_ROOM >= 68992   # a fourth piece
    assert pack_cuda.wide_bytes(14482, 26, 3) == 4 * (58100 + 12) == pack_cuda.MAX_SMEM
    assert pack_cuda.wide_bytes(14483, 26, 3) > pack_cuda.MAX_SMEM


def test_b7_and_b9_byte_counts_match_hand_counted_layouts():
    """The byte counts behind the two new choices, counted by hand.

    B9 at K 32, C 132, a warp's row: the five B8 tables' 16-byte aligned
    covers (rA, rB, n: 396 floats → 400 each; mt, hs: 264 → 268 each),
    scale and I⁻¹ (12), vB (396), 32 partner states of 7 and their 32
    indices, the six staged components at a stride of 132 (33 quads, odd)
    and in warm mode the totals' cover (400). B7 at Vh 12, K 32, F 26, Ne
    3, M 4: G = 2 lanes a pair, 64 pairs a block; rows of D = 48 + 130 + 26
    + 12 = 216 floats; the own span of 3 rows + 9 → 656, 64 partner slots of
    224 padded to 228 (4 mod 32), 64 x 24 scores and 64 records of 29
    floats."""
    plain = 3 * 400 + 2 * 268 + 12 + 396 + 32 * 7 + 32 + 6 * 132
    assert solver_cuda.shared_bytes(32, 132, False) == 4 * plain == 12768
    assert solver_cuda.shared_bytes(32, 132, True) == 4 * (plain + 400) == 14368
    assert solver_cuda.shared_bytes(17, 17, False) == 4 * (
        3 * 56 + 2 * 40 + 12 + 52 + 120 + 20 + 6 * 20)   # 119 → 120; 5 quads at C 17
    assert narrowphase_cuda.group_bytes(12, 32, 26, 3, 4) == 4 * (
        656 + 64 * 228 + 64 * 24 + 64 * 29) == 74560
    # Records wider than a row slot (M 64 at Vh 8: 389 floats) are not staged.
    D = 32 + 5 * 8 + 26 + 12
    assert narrowphase_cuda.group_bytes(8, 32, 8, 3, 64) == 4 * (
        ((63 // 32 + 2) * D + 9) // 4 * 4 + 64 * 132 + 64 * 16)


def test_variant_byte_counts_match_the_kernels_layouts():
    """The Python byte counts behind the choices, at the shapes where the
    choice flips."""
    assert clip_cuda.poly_bytes(256, 32) == 238592 > clip_cuda.MAX_SMEM
    assert clip_cuda.poly_bytes(96, 32) <= clip_cuda.MAX_SMEM
    assert pack_cuda.stage_bytes(723, 26, 3) <= pack_cuda.STAGE_BYTES
    assert pack_cuda.stage_bytes(724, 26, 3) > pack_cuda.STAGE_BYTES
    assert prep_cuda.row_bytes(32, 4, 4) <= prep_cuda.STAGE_BYTES   # K = 32 stays shared
    # B1's CTA variant: six per-face arrays of F + F / 32 + 1 words, 21 words
    # a face of candidates and pool and 160 beside them in shared memory, and
    # two face-major vertex buffers of 3·S floats a face with 8 words of room
    # to align them; B3's vertex variant: 17 words a triangle and a hash
    # table of a power of two >= 4T slots.
    assert clip_cuda.cta_aux_bytes(256) == (6 * 265 + 21 * 256 + 160) * 4
    assert clip_cuda.cta_bytes(256, 32) == clip_cuda.cta_aux_bytes(256) + (6 * 32 * 256 + 8) * 4
    assert labels_cuda.hash_slots(2048) == 8192 and labels_cuda.hash_slots(2049) == 16384
    assert labels_cuda.vertex_bytes(2048) == (17 * 2048 + 8192) * 4 == 172032
    # B7's staged rows: records wider than the row slot go to the general variant.
    assert narrowphase_cuda.staged_bytes(8, 8, 8, 3, 20) == 0
    assert narrowphase_cuda.staged_bytes(8, 8, 8, 3, 4) > 0
    # B2: a face table is 21 words a slot over F rounded up to 32, and 3 bit
    # words a 32 slots rounded up to 4; a warp-a-set set adds 20 B a point.
    assert hull_cuda.table_words(44) == 21 * 64 + 8
    assert hull_cuda.table_words(132) == 21 * 160 + 16
    assert hull_cuda.set_bytes(608, 44) == 16 * 608 + 4 * 608 + 4 * 1352   # the cube's pool
    assert hull_cuda.set_bytes(2187, 44) <= hull_cuda.WARP_SET_BYTES < hull_cuda.set_bytes(2188, 44)
    # The general variant: bit 0 the points in shared memory, bit 1 the table.
    assert hull_cuda.table_words(132) * 4 + 16 * 6560 <= hull_cuda.GENERAL_SMEM
    assert hull_cuda.general_stage(6560, 132) == 3                # the limit-64 pool
    assert hull_cuda.general_stage(11956, 132) == 3
    assert hull_cuda.general_stage(11957, 132) == 2
    assert hull_cuda.general_stage(1, 2400) == 3
    assert hull_cuda.general_stage(1, 2401) == 0


# ---------------------------------------------------------------------------
# The configurations past the old limits against the JAX package.
# ---------------------------------------------------------------------------

BASE = dict(max_faces=26, max_face_verts=16, voronoi_prefix=8, partial_pattern_cell_cnt=8,
            general_pattern_cell_cnt=8, exact_caps=False, initial_decompose_cell_cnt=8,
            max_pieces=8, voronoi_neighbors=7)
PREPARE = {
    "prepare_piece_tris_2048": dict(BASE, max_piece_tris=2048),
    "prepare_refit_limit_64": dict(BASE, refitting_point_limit=64),
    "prepare_faces_256_verts_32": dict(BASE, max_faces=256, max_face_verts=32),
}
# The lattice with the sweep-and-prune B6 (broadphase_block 16 < 27 pieces)
# and every kernel route forced on the JAX side.
FORCED = dict(pallas_narrowphase=True, force_pallas_narrowphase=True, force_pallas_solver=True,
              fused_prep=True, broadphase_block=16, force_pallas_broadphase=True,
              single_piece_bodies=True)
PHYSICS = {
    "physics_neighbors_32": dict(FORCED, max_neighbors=32, max_hull_verts=8),
    "physics_hull_verts_12": dict(FORCED, max_hull_verts=12),
    "physics_hull_verts_24": dict(FORCED, max_hull_verts=24),
}
KEY = 46354
STEPS = 8


def _jax_prepare(out_dir, *names):
    """Child-process side: the JAX package's prepare_fracture of the cube
    on the named PREPARE configurations, each saved with its seeds."""
    for name in names:
        _jax_prepare_one(name, os.path.join(out_dir, f"{name}.npz"))


def _jax_prepare_one(name, out_path):
    from surtr_tpu.config import FractureConfig
    from surtr_tpu.fracture.pattern import radial_seeds, uniform_seeds
    from surtr_tpu.fracture.pipeline import prepare_fracture
    from surtr_tpu.io.models import get_model, sphere_point_cloud
    from surtr_tpu.ops.moments import moments

    res = {}
    v, f = get_model("cube")
    cfg = FractureConfig(**PREPARE[name])
    key = jax.random.PRNGKey(KEY)
    pieces, _, met = prepare_fracture(
        jnp.asarray(v), jnp.ones(len(v), bool), jnp.asarray(v[f]), jnp.ones(len(f), bool),
        jnp.asarray(sphere_point_cloud()), key, cfg)
    k0, k1, k2 = jax.random.split(key, 3)
    res["seeds"] = np.asarray(uniform_seeds(k0, cfg.initial_decompose_cell_cnt))
    res["pseeds"] = np.asarray(
        radial_seeds(k1, cfg.partial_pattern_cell_cnt, cfg.partial_pattern_dist))
    res["gseeds"] = np.asarray(
        radial_seeds(k2, cfg.general_pattern_cell_cnt, cfg.general_pattern_dist))
    for k, val in met.items():
        res[f"m/{k}"] = np.asarray(val)
    res["vol"] = np.asarray(moments(pieces.convex)[0])
    for f_ in ("face_verts", "n_verts", "planes"):
        res[f_] = np.asarray(getattr(pieces.convex, f_))
    for f_ in ("mesh", "mesh_valid", "valid", "group", "tag"):
        res[f_] = np.asarray(getattr(pieces, f_))
    np.savez(out_path, **res)


def _jax_physics(out_dir, *names):
    """Child-process side: per named PHYSICS configuration, the lattice
    built by the JAX package and carried into the port (saved as the
    port's scene), and the JAX state after STEPS steps of
    ``physics_step``."""
    from surtr_tpu.config import PhysicsConfig as JPhysicsConfig
    from surtr_tpu.fracture.types import PieceSet as JPieceSet
    from surtr_tpu.physics.scene import build_scene as j_build_scene
    from surtr_tpu.physics.step import physics_step as j_physics_step
    from surtr_tpu.types import ConvexPoly as JConvexPoly
    from surtr_tpu_torch import convert, workload

    tp = workload.cube_pieces(np.asarray(workload.lattice_offsets(27), np.float32))
    jp = JPieceSet(
        convex=JConvexPoly(*(jnp.asarray(getattr(tp.convex, f).numpy())
                             for f in ("face_verts", "n_verts", "planes"))),
        **{f: jnp.asarray(getattr(tp, f).numpy())
           for f in ("mesh", "mesh_valid", "valid", "group", "tag")})
    for name in names:
        jcfg = JPhysicsConfig(**PHYSICS[name])
        js = j_build_scene(jp, jcfg, max_bodies=27)
        torch.save(convert.scene_from(js), os.path.join(out_dir, f"{name}.start.pt"))
        step = jax.jit(lambda s, jcfg=jcfg: j_physics_step(s, jcfg))
        for _ in range(STEPS):
            js = step(js)
        np.savez(os.path.join(out_dir, f"{name}.npz"), x=np.asarray(js.bodies.x),
                 v=np.asarray(js.bodies.v), q=np.asarray(js.bodies.q),
                 sleep_frames=np.asarray(js.sleep_frames),
                 push_frames=np.asarray(js.push_frames))


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX runs in four child processes, two cases each at most (a
    case costs a compile, a process its imports), all started at the
    file's first case and read when a case needs its result."""
    tmp = tmp_path_factory.mktemp("shape_limits")
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=AVX", JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    phys, prep = list(PHYSICS), list(PREPARE)
    jobs = {"physics_a": phys[:1], "physics_b": phys[1:], "prepare_a": prep[:1],
            "prepare_b": prep[1:]}
    procs = {job: subprocess.Popen([sys.executable, os.path.abspath(__file__), job, str(tmp),
                                    *names], env=env, stdout=subprocess.DEVNULL,
                                   stderr=subprocess.PIPE, text=True)
             for job, names in jobs.items()}
    done = {}

    def result(name):
        job = next(j for j, names in jobs.items() if name in names)
        if procs[job].returncode is None:
            _, err = procs[job].communicate(timeout=600)
            assert procs[job].returncode == 0, err[-4000:]
        if name not in done:
            done[name] = dict(np.load(tmp / f"{name}.npz"))
            if name in PHYSICS:
                done[name]["start"] = torch.load(tmp / f"{name}.start.pt", weights_only=False)
        return done[name]

    yield result
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _check_prepare(name, ref):
    from surtr_tpu_torch.config import FractureConfig
    from surtr_tpu_torch.fracture.pipeline import prepare_fracture
    from surtr_tpu_torch.io.models import get_model, sphere_point_cloud
    from surtr_tpu_torch.ops.moments import moments

    r = lambda k: ref[k]  # noqa: E731
    v, f = get_model("cube")
    t = torch.as_tensor
    pieces, ctx, met = prepare_fracture(
        t(v), torch.ones(len(v), dtype=torch.bool), t(v[f]), torch.ones(len(f), dtype=torch.bool),
        t(sphere_point_cloud()), FractureConfig(**PREPARE[name]), t(r("seeds")), t(r("pseeds")),
        t(r("gseeds")))
    for k in ("piece_cnt", "ich_face_cnt", "mesh_tris_dropped"):
        assert int(met[k]) == int(r(f"m/{k}")), k
    assert int(met["piece_cnt"]) > 0
    np.testing.assert_allclose(float(met["total_volume"]), float(r("m/total_volume")), rtol=1e-5)
    mas = float(ctx.max_axis_scale)
    np.testing.assert_array_equal(pieces.valid.numpy(), r("valid"))
    np.testing.assert_array_equal(pieces.group.numpy(), r("group"))
    np.testing.assert_allclose(moments(pieces.convex)[0].numpy(), r("vol"), atol=1e-6 * mas ** 3)
    np.testing.assert_array_equal(pieces.convex.n_verts.numpy(), r("n_verts"))
    sm = pieces.convex.slot_mask().numpy()[..., None]
    np.testing.assert_allclose(np.where(sm, pieces.convex.face_verts.numpy(), 0),
                               np.where(sm, r("face_verts"), 0), atol=1e-5 * mas)
    fm = pieces.convex.face_mask().numpy()[..., None]
    np.testing.assert_allclose(np.where(fm, pieces.convex.planes.numpy(), 0),
                               np.where(fm, r("planes"), 0), atol=1e-5 * mas)
    np.testing.assert_array_equal(pieces.mesh_valid.numpy(), r("mesh_valid"))
    mv = pieces.mesh_valid.numpy()[..., None, None]
    np.testing.assert_allclose(np.where(mv, pieces.mesh.numpy(), 0),
                               np.where(mv, r("mesh"), 0), atol=1e-5 * mas)


def _check_physics(name, ref):
    from surtr_tpu_torch import convert
    from surtr_tpu_torch.config import PhysicsConfig
    from surtr_tpu_torch.physics.step import physics_step

    ts = ref["start"]
    tcfg = convert.physics_config_from(PhysicsConfig(**PHYSICS[name]))
    for _ in range(STEPS):
        ts = physics_step(ts, tcfg)
    np.testing.assert_allclose(ts.bodies.x.numpy(), ref["x"], atol=2e-4)
    np.testing.assert_allclose(ts.bodies.v.numpy(), ref["v"], atol=2e-3)
    np.testing.assert_allclose(ts.bodies.q.numpy(), ref["q"], atol=2e-4)
    np.testing.assert_array_equal(ts.sleep_frames.numpy(), ref["sleep_frames"])
    np.testing.assert_array_equal(ts.push_frames.numpy(), ref["push_frames"])
    assert torch.isfinite(ts.bodies.w).all()


@pytest.mark.parametrize("case", list(PHYSICS) + list(PREPARE))
def test_past_the_old_limits_matches_jax(case, jax_ref):
    if case in PREPARE:
        _check_prepare(case, jax_ref(case))
    else:
        _check_physics(case, jax_ref(case))


if __name__ == "__main__":
    if sys.argv[1].startswith("physics"):
        _jax_physics(sys.argv[2], *sys.argv[3:])
    else:
        _jax_prepare(sys.argv[2], *sys.argv[3:])
