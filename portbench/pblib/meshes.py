"""The benchmark's meshes, made here and never taken from the program's
model registry: a copy of the port's procedural torus (``io.models._torus``
with its vertex weld) and of its impact-sphere cloud, so that a later change
to the program's models cannot move the yardstick."""

from __future__ import annotations

import os

import numpy as np


def weld(verts: np.ndarray, tris: np.ndarray, decimals: int = 6):
    """Merge positionally identical vertices and drop degenerate triangles
    (first occurrence keeps its place)."""
    key = np.round(verts, decimals)
    _, first, inverse = np.unique(key, axis=0, return_index=True, return_inverse=True)
    remap = inverse.reshape(-1)
    new_tris = remap[tris]
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    new_tris = rank[new_tris]
    verts = verts[np.sort(first)]
    ok = ((new_tris[:, 0] != new_tris[:, 1]) & (new_tris[:, 1] != new_tris[:, 2])
          & (new_tris[:, 0] != new_tris[:, 2]))
    return verts, new_tris[ok]


def torus(R: float = 1.2, r: float = 0.5, nu: int = 24, nv: int = 12):
    """The torus of tube radius ``r`` about a ring of radius ``R`` in the xz
    plane, ``nu`` × ``nv`` quads split in two → (verts (V, 3) f32, tris (T, 3)
    i32)."""
    verts = []
    for u in np.linspace(0, 2 * np.pi, nu, endpoint=False):
        for w in np.linspace(0, 2 * np.pi, nv, endpoint=False):
            verts.append([(R + r * np.cos(w)) * np.cos(u), r * np.sin(w),
                          (R + r * np.cos(w)) * np.sin(u)])
    tris = []
    for i in range(nu):
        for j in range(nv):
            a = i * nv + j
            b = i * nv + (j + 1) % nv
            c = ((i + 1) % nu) * nv + j
            d = ((i + 1) % nu) * nv + (j + 1) % nv
            tris += [[a, b, d], [a, d, c]]
    v, f = weld(np.asarray(verts, np.float64), np.asarray(tris, np.int64))
    return v.astype(np.float32), f.astype(np.int32)


def obj_text(verts, tris) -> str:
    """A mesh as Wavefront OBJ text; each coordinate reads back to the same
    float32."""
    lines = [f"v {x!r} {y!r} {z!r}" for x, y, z in np.asarray(verts, np.float64).tolist()]
    lines += [f"f {a} {b} {c}" for a, b, c in (np.asarray(tris, np.int64) + 1).tolist()]
    return "\n".join(lines) + "\n"


def write_obj(verts, tris, directory: str, name: str) -> str:
    """``obj_text`` written to ``directory``/``name``.obj; returns the path."""
    path = os.path.join(directory, f"{name}.obj")
    with open(path, "w") as fh:
        fh.write(obj_text(verts, tris))
    return path


def icosphere_points(subdiv: int = 1, radius: float = 0.5) -> np.ndarray:
    """The vertices of an icosahedron refined ``subdiv`` times onto the
    sphere (42 at ``subdiv`` 1): the reference's impact-sphere cloud, its
    sphere.obj at scale 0.5."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t], [0, 1, t],
                  [0, -1, -t], [0, 1, -t], [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]],
                 np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9],
                  [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2],
                  [3, 2, 6], [3, 6, 8], [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10],
                  [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(subdiv):
        mid, verts = {}, list(v)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                m = verts[a] + verts[b]
                mid[key] = len(verts)
                verts.append(m / np.linalg.norm(m))
            return mid[key]

        nf = []
        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v, f = np.asarray(verts), np.asarray(nf, np.int64)
    return (v * radius).astype(np.float32)


MESHES = {"torus": torus}


def mesh(spec: dict):
    """The mesh a configuration names: ``{"generator": "torus", ...
    arguments}`` → (verts, tris)."""
    args = {k: v for k, v in spec.items() if k != "generator"}
    return MESHES[spec["generator"]](**args)
