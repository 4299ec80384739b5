"""Wavefront OBJ parsing (numpy only; counterpart of ``surtr_tpu/io/obj.py``).

Triangulates polygon faces, welds identical vertices, mirrors X and flips
winding like the reference's Assimp import, then applies a scale/offset.
"""

from __future__ import annotations

import numpy as np


def parse_obj(
    text: str,
    scale=(1.0, 1.0, 1.0),
    offset=(0.0, 0.0, 0.0),
    mirror_x: bool = True,
):
    """Parse OBJ text → (verts (V,3) f32 welded, tris (T,3) i32).

    Polygon faces are fan-triangulated (Assimp aiProcess_Triangulate).
    """
    verts = []
    faces = []
    for line in text.splitlines():
        if line.startswith("v "):
            parts = line.split()
            verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
        elif line.startswith("f "):
            idx = []
            for tok in line.split()[1:]:
                i = tok.split("/")[0]
                k = int(i)
                idx.append(k - 1 if k > 0 else len(verts) + k)
            for t in range(1, len(idx) - 1):
                faces.append([idx[0], idx[t], idx[t + 1]])
    v = np.asarray(verts, np.float64)
    f = np.asarray(faces, np.int64).reshape(-1, 3)
    if mirror_x:
        v[:, 0] = -v[:, 0]
        f = f[:, ::-1]  # FlipWindingOrder to keep outward orientation
    v = v * np.asarray(scale, np.float64) + np.asarray(offset, np.float64)
    v, f = weld(v, f)
    return v.astype(np.float32), f.astype(np.int32)


def load_obj(path: str, scale=(1, 1, 1), offset=(0, 0, 0), mirror_x=True):
    with open(path) as fh:
        return parse_obj(fh.read(), scale, offset, mirror_x)


def weld(verts: np.ndarray, tris: np.ndarray, decimals: int = 6):
    """Merge positionally identical vertices (JoinIdenticalVertices) and drop
    degenerate triangles. Exact-duplicate welding via rounded keys."""
    key = np.round(verts, decimals)
    _, first, inverse = np.unique(
        key, axis=0, return_index=True, return_inverse=True
    )
    remap = inverse.reshape(-1)
    new_tris = remap[tris]
    # Re-index so vertex order is stable (order of first occurrence).
    order = np.argsort(first)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    new_verts = verts[np.sort(first)]
    new_tris = rank[new_tris]
    keep = (
        (new_tris[:, 0] != new_tris[:, 1])
        & (new_tris[:, 1] != new_tris[:, 2])
        & (new_tris[:, 0] != new_tris[:, 2])
    )
    return new_verts, new_tris[keep]
