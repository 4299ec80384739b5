"""The bound arithmetic against hand counts."""

import math
import os

import torch

from conftest import PB
from pblib import bounds
from pblib.harness import load_file


def kernel(name):
    return load_file(os.path.join(PB, "kernels", name + ".py"), "k_" + name)


def test_bytes_and_bound():
    a = torch.zeros((10, 4), dtype=torch.float32)          # 160 B
    b = torch.zeros((3,), dtype=torch.bool)                 # 3 B
    assert bounds.nbytes((a, {"k": b}, 5, None)) == 163
    # 3.35e9 B is 1 ms at the memory rate; 67e9 operations 1 ms at FP32.
    assert math.isclose(bounds.bound_s(3.35e9, 0), 1e-3)
    assert math.isclose(bounds.bound_s(3.35e9, 134e9), 2e-3)
    assert math.isclose(bounds.bound_s(0, 67e9), 1e-3)


def test_clip_fold_counts_live_planes_times_live_vertices():
    from types import SimpleNamespace

    n_verts = torch.tensor([[4, 3, 0], [5, -1, 0]])          # 7 and 5 live vertices
    mask = torch.tensor([[True, True, False], [True, False, False]])
    ops = kernel("clip_fold").ops((SimpleNamespace(n_verts=n_verts), None, mask, 1e-6), {})
    assert ops == (2 * 7 + 1 * 5) * 6


def test_refit_labels_ich_soup_counts():
    tm = torch.tensor([[True, False], [True, True]])         # 3 triangles → 9 points
    cm = torch.tensor([[True], [False]])                     # 1 cap point
    assert kernel("refit").ops((None, tm, None, cm), {}) == 10 * 64.0
    corners = torch.zeros((2, 2, 3, 3))
    assert kernel("labels").ops((corners, tm, 1e-5, None), {}) == 18.0 * 4 + 36.0 * 3
    mask = torch.ones((1, 10), dtype=torch.bool)
    assert kernel("ich").ops((None, mask, 4, 12, False), {}) == 10 * 4 * 12 * 6.0
    cell = torch.tensor([0, 1, 5, 0])                        # lane 2's cell is out of range
    valid = torch.tensor([True, True, True, False])
    pmask = torch.tensor([[True, True, False], [True, False, False]])
    planes = torch.zeros((2, 3, 4))
    assert kernel("soup_clip").ops((None, valid, cell, planes, pmask), {}) == (2 + 1) * 18


def test_raster_counts_box_pixels_of_live_triangles():
    attrs = torch.zeros((3, 10))
    attrs[0, :6] = torch.tensor([0.5, 0.5, 4.5, 0.5, 0.5, 2.5])    # box 0..5 × 0..3 = 15 px
    attrs[0, 9] = 1.0
    attrs[1, :6] = torch.tensor([0.0, 0.0, 1.0, 1.0, 2.0, 2.0])    # no area
    attrs[1, 9] = 1.0
    attrs[2, :6] = torch.tensor([0.0, 0.0, 9.0, 0.0, 0.0, 9.0])    # not live
    ops = kernel("raster").ops((attrs, None, None, 1, 1, 64, 64, 0, None), {})
    assert ops == 15 * 29
