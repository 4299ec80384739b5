"""Driver ``frames``: one Scene chained through the whole window, each
event one ``Scene.interactive_frame`` (raycast, refracture, rebuild, one
physics step, a shadow-mapped frame) with the ray of frame ``i`` drawn from
the seed (``traffic.down_ray``) and the cell's camera. The warm frames run
from the prepared Scene, which is then put back, so the window starts from
it.

The check follows the program from its own state, since the reference
cannot chain hundreds of frames on the CPU in a run's time: the start (the
prepared Scene against the reference's own, prepared from the same mesh
and seed) and one frame drawn from the seed (the reference's
``interactive_frame`` from the program's state before that frame, with
the reference's own fracture context: pieces, bodies after the step and
the image)."""

from __future__ import annotations

import types

import torch

from pblib import compare, scenes, traffic


def setup(ctx):
    sc = scenes.build("surtr_tpu_torch", ctx.config, ctx.device)
    return types.SimpleNamespace(ctx=ctx, sc=sc, prepared=scenes.state(sc),
                                 sample=traffic.sample_index(ctx.seed, ctx.cell["sample_below"]),
                                 kept=None, last=None)


def _frame(st, i):
    t = st.ctx.cell["traffic"]
    origin, direction = traffic.down_ray(st.ctx.seed, i, t)
    before = (st.sc.pieces, st.sc.phys, st.sc._x0)
    img, _ = st.sc.interactive_frame(origin, direction, eye=tuple(t["eye"]),
                                     target=tuple(t["target"]))
    scenes.sync(st.ctx.device)
    return (i, before, (st.sc.pieces, st.sc.phys, st.sc._x0), img)


def warm(st):
    for k in range(st.ctx.cell["warm_events"]):
        _frame(st, 10**9 + k)
    scenes.restore(st.sc, st.prepared)


def event(st, i) -> bool:
    st.last = _frame(st, i)
    if i == st.sample:
        st.kept = st.last
    return True


def reference_frame(st, i, before, ref, fracture=None):
    """The reference's frame ``i`` from the state ``before`` (on the CPU),
    with the context of ``ref``, the reference's Scene; ``fracture``
    replaces its ``do_fracture`` (the control). Returns (pieces, bodies,
    image)."""
    import plainref.scene as ref_scene

    t = st.ctx.cell["traffic"]
    origin, direction = traffic.down_ray(st.ctx.seed, i, t)
    if fracture is not None:
        orig, ref_scene.do_fracture = ref_scene.do_fracture, fracture(ref_scene.do_fracture)
    try:
        pieces, phys, _, img, _ = ref_scene.interactive_frame(
            *compare.as_reference(before), ref.ctx, origin, direction, tuple(t["eye"]), tuple(t["target"]), ref.cfg)
    finally:
        if fracture is not None:
            ref_scene.do_fracture = orig
    return pieces, phys, img


def check(st, n_events):
    i, before, after, img = st.kept or st.last
    start = compare.to_cpu(st.prepared[:2])
    before, after, img = compare.to_cpu(before), compare.to_cpu(after), img.detach().cpu()
    st.kept = st.last = st.prepared = st.sc = None
    if st.ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = scenes.build("plainref", st.ctx.config, "cpu")
    scale = float(ref.ctx.max_axis_scale)
    at_start = scenes.numbers(*start, ref.pieces, ref.phys, scale)
    want_p, want_b, want_img = reference_frame(st, i, before, ref)
    at_frame = {**scenes.numbers(after[0], after[1], want_p, want_b, scale),
                **compare.image_gap(img, want_img)}
    res = scenes.worst(at_start, at_frame)
    lim = st.ctx.cell["limits"]
    return [(k, float(v), float(lim[k])) for k, v in res.items()]
