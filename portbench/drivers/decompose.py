"""Driver ``decompose``: a closed loop of one client, each event one
``prepare_fracture`` of the configuration's model, loaded at set-up as a
user's OBJ is (its text written under ``TMPDIR`` and read back by the
program's ``load_obj``), with event ``i``'s own seed triple
(``traffic.fracture_seeds``).

The check: one event drawn from the seed (``traffic.sample_index``),
worked out again by the reference (``plainref``, on the CPU, from the same
OBJ file and seeds) and compared slot for slot (``compare.piece_gaps``)."""

from __future__ import annotations

import types

import torch

from pblib import compare, configs, meshes, traffic


def _inputs(package: str, path: str, device):
    """``prepare_fracture``'s model arguments, the OBJ read by ``package``'s
    ``load_obj``; the impact-sphere cloud is the benchmark's."""
    import importlib

    verts, tris = importlib.import_module(package + ".io.obj").load_obj(path)
    v = torch.as_tensor(verts, device=device)
    return (v, torch.ones(len(verts), dtype=torch.bool, device=device),
            torch.as_tensor(verts[tris], device=device),
            torch.ones(len(tris), dtype=torch.bool, device=device),
            torch.as_tensor(meshes.icosphere_points(), device=device))


def setup(ctx):
    from surtr_tpu_torch.fracture.pipeline import prepare_fracture

    v, f = meshes.mesh(ctx.config["mesh"])
    path = meshes.write_obj(v, f, ctx.tmpdir, ctx.config["name"])
    return types.SimpleNamespace(
        ctx=ctx, path=path, prepare=prepare_fracture,
        inputs=_inputs("surtr_tpu_torch", path, ctx.device),
        cfg=configs.fracture("surtr_tpu_torch", ctx.config["fracture"]),
        sample=traffic.sample_index(ctx.seed, ctx.cell["sample_below"]),
        kept=None, last=None)


def _seeds(st, i):
    return traffic.fracture_seeds(st.ctx.seed, i, st.ctx.config["fracture"])


def _sync(st):
    if st.ctx.device.type == "cuda":
        torch.cuda.synchronize(st.ctx.device)


def warm(st):
    """Events of the window's shapes on seeds of their own (indices past
    any the window reaches)."""
    for k in range(st.ctx.cell["warm_events"]):
        st.prepare(*st.inputs, st.cfg, *_seeds(st, 10**9 + k))
    _sync(st)


def event(st, i) -> bool:
    pieces, _, met = st.prepare(*st.inputs, st.cfg, *_seeds(st, i))
    _sync(st)
    st.last = (i, pieces, met)
    if i == st.sample:
        st.kept = st.last
    return True


def reference(st, i, dtype=torch.float32):
    """The reference's event ``i`` on the CPU, the model cast to ``dtype``
    and the seeds rounded to it (they stay float32: the pipeline's
    sentinels overflow a narrower type)."""
    from plainref.fracture.pipeline import prepare_fracture

    inputs = tuple(t.to(dtype) if t.is_floating_point() else t
                   for t in _inputs("plainref", st.path, "cpu"))
    cfg = configs.fracture("plainref", st.ctx.config["fracture"])
    seeds = tuple(s.to(dtype).float() for s in _seeds(st, i))
    pieces, ctx, met = prepare_fracture(*inputs, cfg, *seeds)
    return compare.tree_map(pieces, lambda t: t.float() if t.is_floating_point() else t), \
        float(ctx.max_axis_scale), met


def numbers(got, met, want, wmet, scale) -> dict:
    out = compare.piece_gaps(got, want, scale)
    out["piece_slots"] += sum(int(met[k]) != int(wmet[k])
                              for k in ("piece_cnt", "mesh_tris_dropped", "ich_face_cnt"))
    return out


def check(st, n_events):
    i, pieces, met = st.kept or st.last
    got, gmet = compare.to_cpu(pieces), compare.to_cpu(met)
    st.kept = st.last = st.inputs = None
    if st.ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    want, scale, wmet = reference(st, i)
    res = numbers(got, gmet, want, wmet, scale)
    lim = st.ctx.cell["limits"]
    return [(k, float(v), float(lim[k])) for k, v in res.items()]
