"""Built-in procedural models and the reference model registry (numpy
only; counterpart of ``surtr_tpu/io/models.py``).

Equivalent shapes to the reference's OBJ models, generated procedurally,
the 42-point impact-sphere cloud and area-weighted vertex normals. When the
reference's resource tree is mounted under ``REFERENCE_ROOT`` (the
``SURTR_REFERENCE_ROOT`` environment variable), its OBJs load by name
(``load_reference_model``, and ``get_model`` for a name that is not
procedural).
"""

from __future__ import annotations

import os

import numpy as np

from plainref.io.obj import load_obj, weld

REFERENCE_MODELS = {
    # name: (relative path, scale, offset) — the model table of
    # Surtr.cpp:1397-1421 (model indices 0-6) plus the sphere point cloud
    # (Surtr.cpp:1508, scale 0.5) and the ground (Surtr.cpp:1523, 0.015).
    "bunny": ("Resources/Models/lowpoly-bunny-closed.obj", (70, 70, 70), (0, 0, 0)),
    "cube": ("Resources/Models/cube.obj", (3, 3, 3), (0, 0, 0)),
    "pumpkin": ("Resources/Models/pumpkin.obj", (0.15, 0.15, 0.15), (0, 0, 0)),
    "cylinder": ("Resources/Models/cylinder.obj", (3, 3, 3), (0, 0, 0)),
    "highpoly-sphere": ("Resources/Models/highpoly-sphere.obj", (5, 5, 5), (0, 0, 0)),
    "cessna": ("Resources/Models/cessna.obj", (0.6, 0.6, 0.6), (0, 0, 0)),
    "shuttle": ("Resources/Models/shuttle.obj", (1, 1, 1), (0, 0, 0)),
    "sphere": ("Resources/Models/sphere.obj", (0.5, 0.5, 0.5), (0, 0, 0)),
    "ground": ("Resources/Models/ground.obj", (0.015, 0.015, 0.015), (0, -2, 0)),
}

# The root of a checkout of the reference (the directory that holds
# ``Resources/Models``): ``SURTR_REFERENCE_ROOT``, else ``reference/`` at
# the root of this repository.
REFERENCE_ROOT = os.environ.get(
    "SURTR_REFERENCE_ROOT",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                 "reference"),
)


def load_reference_model(name: str):
    """The registry model ``name`` read from its OBJ under ``REFERENCE_ROOT``
    at its scale and offset → (verts (V, 3) f32, tris (T, 3) i32)."""
    rel, scale, offset = REFERENCE_MODELS[name]
    return load_obj(os.path.join(REFERENCE_ROOT, rel), scale, offset)


def box(extent=(1.0, 1.0, 1.0), center=(0.0, 0.0, 0.0)):
    """Triangulated box; 8 verts / 12 tris like the reference cube model."""
    e = np.asarray(extent, np.float64) * 0.5
    c = np.asarray(center, np.float64)
    v = (
        np.array(
            [[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)],
            np.float64,
        )
        * e
        + c
    )
    # CCW-outward faces of the (x,y,z in {-1,1}) corner ordering.
    quads = [
        (4, 6, 7, 5),  # +x
        (0, 1, 3, 2),  # -x
        (2, 3, 7, 6),  # +y
        (0, 4, 5, 1),  # -y
        (1, 5, 7, 3),  # +z
        (0, 2, 6, 4),  # -z
    ]
    tris = []
    for a, b, cc, dd in quads:
        tris += [[a, b, cc], [a, cc, dd]]
    return v.astype(np.float32), np.asarray(tris, np.int32)


def icosphere(subdiv: int = 1, radius: float = 1.0):
    """Icosahedron-based sphere (42 verts at subdiv=1 — matching the
    reference's sphere.obj point count, SURVEY §1 L2)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    for _ in range(subdiv):
        mid = {}
        verts = list(v)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                m = verts[a] + verts[b]
                m /= np.linalg.norm(m)
                mid[key] = len(verts)
                verts.append(m)
            return mid[key]

        nf = []
        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.asarray(verts)
        f = np.asarray(nf, np.int64)
    v = (v * radius).astype(np.float32)
    return v, f.astype(np.int32)


def sphere_point_cloud(radius: float = 0.5):
    """The impact-test point cloud: the reference loads sphere.obj at scale
    0.5 and keeps its vertices (Surtr.cpp:1506-1517)."""
    v, _ = icosphere(subdiv=1, radius=radius)
    return v


def get_model(name: str):
    """Model by name: procedural first, then a registry model whose OBJ is
    mounted under ``REFERENCE_ROOT``; ``KeyError`` otherwise."""
    procedural = {
        "cube": lambda: box((3.0, 3.0, 3.0)),
        "box": lambda: box(),
        "sphere": lambda: icosphere(2, 1.5),
        "blob": lambda: _blob(),
        "torus": lambda: _torus(),
    }
    if name in procedural:
        return procedural[name]()
    if name in REFERENCE_MODELS and os.path.exists(
        os.path.join(REFERENCE_ROOT, REFERENCE_MODELS[name][0])
    ):
        return load_reference_model(name)
    raise KeyError(f"unknown model {name!r}")


def _blob(n: int = 2, seed: int = 0):
    """Bumpy sphere — a stand-in for organic meshes (pumpkin/bunny-like)."""
    v, f = icosphere(n, 1.0)
    rng = np.random.default_rng(seed)
    freq = rng.uniform(1.5, 3.0, size=3)
    phase = rng.uniform(0, np.pi, size=3)
    r = 1.0 + 0.25 * (
        np.sin(freq[0] * v[:, 0] * 3 + phase[0])
        * np.sin(freq[1] * v[:, 1] * 3 + phase[1])
        * np.sin(freq[2] * v[:, 2] * 3 + phase[2])
    )
    return (v * r[:, None] * 1.5).astype(np.float32), f


def _torus(R: float = 1.2, r: float = 0.5, nu: int = 24, nv: int = 12):
    us = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    vs = np.linspace(0, 2 * np.pi, nv, endpoint=False)
    verts = []
    for u in us:
        for w in vs:
            verts.append(
                [
                    (R + r * np.cos(w)) * np.cos(u),
                    r * np.sin(w),
                    (R + r * np.cos(w)) * np.sin(u),
                ]
            )
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


def smooth_vertex_normals(verts, tris):
    """Area-weighted per-vertex normals as a per-corner (T, 3, 3) array, for
    ``render_scene(..., normals=...)``: procedural and OBJ models carry no
    authored normals (the reference imports them with Assimp)."""
    v = np.asarray(verts, np.float32)
    f = np.asarray(tris, np.int64)
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    vn = np.zeros_like(v)
    for c in range(3):
        np.add.at(vn, f[:, c], fn)
    ln = np.linalg.norm(vn, axis=1, keepdims=True)
    vn = vn / np.maximum(ln, 1e-12)
    return vn[f]
