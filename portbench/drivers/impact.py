"""Driver ``impact``: a closed loop of one client, each event one
``Scene.fire_impact`` on the configuration's Scene as prepared at set-up
(its pieces, bodies, x0, time and events put back before every click, so
every click lands on the intact model), the ray of event ``i`` drawn from
the seed (``traffic.down_ray``). A click whose ray misses counts as
failed.

The check: one click drawn from the seed, worked out again by the
reference (``plainref``, on the CPU: its own Scene prepared from the same
mesh and seed, then the same click) and compared: pieces slot for slot and
the rebuilt bodies (``scenes.numbers``)."""

from __future__ import annotations

import types

import torch

from pblib import compare, scenes, traffic


def setup(ctx):
    sc = scenes.build("surtr_tpu_torch", ctx.config, ctx.device)
    return types.SimpleNamespace(ctx=ctx, sc=sc, prepared=scenes.state(sc),
                                 sample=traffic.sample_index(ctx.seed, ctx.cell["sample_below"]),
                                 kept=None, last=None)


def _ray(st, i):
    return traffic.down_ray(st.ctx.seed, i, st.ctx.cell["traffic"])


def _click(st, i, ray):
    scenes.restore(st.sc, st.prepared)
    met = st.sc.fire_impact(*ray)
    scenes.sync(st.ctx.device)
    return bool(met)


def warm(st):
    for k in range(st.ctx.cell["warm_events"]):
        _click(st, None, _ray(st, 10**9 + k))
    scenes.restore(st.sc, st.prepared)


def event(st, i) -> bool:
    ok = _click(st, i, _ray(st, i))
    st.last = (i, st.sc.pieces, st.sc.phys)
    if i == st.sample:
        st.kept = st.last
    return ok


def reference(st, i, fracture=None):
    """The reference's click ``i`` on its own prepared Scene (CPU);
    ``fracture`` replaces its ``do_fracture`` (the control). Returns
    (pieces, bodies, scale)."""
    import plainref.scene as ref_scene

    sc = scenes.build("plainref", st.ctx.config, "cpu")
    if fracture is not None:
        orig, ref_scene.do_fracture = ref_scene.do_fracture, fracture(ref_scene.do_fracture)
    try:
        sc.fire_impact(*_ray(st, i))
    finally:
        if fracture is not None:
            ref_scene.do_fracture = orig
    return sc.pieces, sc.phys, float(sc.ctx.max_axis_scale)


def check(st, n_events):
    i, pieces, phys = st.kept or st.last
    got_p, got_b = compare.to_cpu(pieces), compare.to_cpu(phys)
    st.kept = st.last = st.prepared = st.sc = None
    if st.ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    want_p, want_b, scale = reference(st, i)
    res = scenes.numbers(got_p, got_b, want_p, want_b, scale)
    lim = st.ctx.cell["limits"]
    return [(k, float(v), float(lim[k])) for k, v in res.items()]
