"""Software rasterizer (counterpart of ``surtr_tpu/render/raster.py``).

Two passes, as the reference frame draws them: a depth-only shadow pass from
the light's ortho frustum, then the camera pass, z-buffered and flat-shaded
with Lambert diffuse, ambient light and a 3 × 3 (9-tap) PCF shadow filter.

``raster_screen`` dispatches by shape as the JAX package does on its
accelerator: W % 128 == 0 and H % 32 == 0 take the tiled raster (kernel
B11 on CUDA tensors, its plain version on CPU tensors,
``raster_cuda.py``); other shapes take the row-tile sweep, plain PyTorch on
every device, as the JAX package runs it in XLA everywhere. Both give the
same depth and, up to ties, the same ids.

Products over 3 or 4 terms are written out in a fixed order (``dot3``,
``_dot4``, the orders the JAX package's CPU runs sum in) and norms take
``sqrt_rn``, so the card and the CPU agree bit for bit.
"""

from __future__ import annotations

import torch

from plainref.ops.hull import _cross
from plainref.ops.linalg import div_rn, dot3, sqrt_rn
from plainref.render.camera import normalize
from plainref.render.raster_cuda import rasterize_ids_tiled

BIG = 3.4e38
W_EPS = 1e-4
TILE_ROWS = 32     # the row-tile sweep's band height
TRI_BLOCK = 512    # and its triangle block
BACKGROUND = (0.12, 0.15, 0.18)


def _dot4(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(4, 4) matrix times (..., 4) points → (..., 4), each row
    (m0·v0 + m1·v1) + (m2·v2 + m3·v3), the order XLA:CPU sums a length-4
    contraction in."""
    return ((m[:, 0] * v[..., None, 0] + m[:, 1] * v[..., None, 1])
            + (m[:, 2] * v[..., None, 2] + m[:, 3] * v[..., None, 3]))


def _homogeneous(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def _unit(v: torch.Tensor) -> torch.Tensor:
    """v / max(|v|, 1e-12) over the last axis."""
    return v / torch.clamp(sqrt_rn(dot3(v, v)), min=1e-12)[..., None]


def _project(tris_world: torch.Tensor, mvp: torch.Tensor) -> torch.Tensor:
    """(T, 3, 3) world triangles → clip space (T, 3, 4)."""
    return _dot4(mvp, _homogeneous(tris_world))


def _screen(clip: torch.Tensor, W: int, H: int):
    """Clip → (screen x, screen y, NDC z, 1/w), w clamped for vertices
    behind the eye."""
    w = clip[..., 3:4]
    ws = torch.where(torch.abs(w) > 1e-9, w, 1e-9)
    ndc = clip[..., :3] / ws
    x = (ndc[..., 0] + 1.0) * 0.5 * W
    y = (1.0 - ndc[..., 1]) * 0.5 * H
    return x, y, ndc[..., 2], 1.0 / ws[..., 0]


def _near_clip_full(clip: torch.Tensor, valid: torch.Tensor, aux: torch.Tensor):
    """Clip triangles against the near plane w > W_EPS: a triangle with one
    or two vertices behind the eye becomes one or two smaller triangles.
    ``aux`` (T, 3, D) per-vertex attributes are lerped with the same
    parameter. Returns ((2T, 3, 4), (2T, 3, D), (2T,) valid)."""
    w = clip[..., 3]
    inside = w > W_EPS
    n_in = inside.sum(-1)
    v = torch.cat([clip, aux], dim=-1)
    r1 = v[:, [1, 2, 0]]
    r2 = v[:, [2, 0, 1]]
    i0, i1, i2 = inside[:, 0], inside[:, 1], inside[:, 2]
    ins = [(i0, i1, i2), (i1, i2, i0), (i2, i0, i1)]
    # Canonical rotation: one inside → that vertex in slot 0; two inside →
    # the outside vertex in slot 2.
    want1 = [a & ~b & ~c for a, b, c in ins]
    want2 = [a & b & ~c for a, b, c in ins]
    sel1 = torch.where(want1[0], 0, torch.where(want1[1], 1, 2))
    sel2 = torch.where(want2[0], 0, torch.where(want2[1], 1, 2))
    sel = torch.where(n_in == 1, sel1, sel2)[:, None, None]
    rot = torch.where(sel == 0, v, torch.where(sel == 1, r1, r2))
    A, B, C = rot[:, 0], rot[:, 1], rot[:, 2]

    def lerp_w(P, Q):
        dw = P[:, 3] - Q[:, 3]
        t = (P[:, 3] - W_EPS) / torch.where(torch.abs(dw) > 1e-12, dw, 1.0)
        t = torch.clamp(t, 0.0, 1.0)[:, None]
        return P + t * (Q - P)

    one_t1 = torch.stack([A, lerp_w(A, B), lerp_w(A, C)], dim=1)
    bc = lerp_w(B, C)
    ca = lerp_w(A, C)
    two_t1 = torch.stack([A, B, bc], dim=1)
    two_t2 = torch.stack([A, bc, ca], dim=1)
    n3 = n_in[:, None, None]
    t1 = torch.where(n3 == 3, v, torch.where(n3 == 1, one_t1, two_t1))
    out = torch.cat([t1, two_t2])
    ok = torch.cat([valid & (n_in >= 1), valid & (n_in == 2)])
    return out[..., :4], out[..., 4:], ok


def _near_clip_pooled(clip: torch.Tensor, valid: torch.Tensor):
    """Near clip with the second sub-triangles compacted stably into a pool
    of TP2 = min(T, max(256, T // 8)) rows; overflow drops the extra piece
    of the overflowing triangles. Returns (clip (T + TP2, 3, 4), ok
    (T + TP2,), src (T + TP2,) int64 source-triangle ids)."""
    T = clip.shape[0]
    c2, _, v2 = _near_clip_full(clip, valid, clip[..., :0])
    t1, t2 = c2[:T], c2[T:]
    v1, need2 = v2[:T], v2[T:]
    TP2 = min(T, max(256, T // 8))
    src2 = torch.argsort((~need2).to(torch.int32), stable=True)[:TP2]
    src = torch.cat([torch.arange(T, device=clip.device), src2])
    return torch.cat([t1, t2[src2]]), torch.cat([v1, need2[src2]]), src


def near_clip(clip: torch.Tensor, valid: torch.Tensor):
    """Near-plane clip in clip space. Returns ((2T, 3, 4), (2T,))."""
    c2, _, v2 = _near_clip_full(clip, valid, clip[..., :0])
    return c2, v2


def _sweep(sx, sy, sz, ok, W: int, H: int):
    """The row-tile sweep: per band of TILE_ROWS rows, blocks of TRI_BLOCK
    triangles in order, the first minimum of a block replacing the band's
    depth only where strictly smaller."""
    tile_rows, tri_block = TILE_ROWS, TRI_BLOCK
    T = sx.shape[0]
    dev = sx.device
    pad = (-T) % tri_block
    padt = lambda a: torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])  # noqa: E731
    sx, sy, sz, ok = padt(sx), padt(sy), padt(sz), padt(ok)
    nblk = (T + pad) // tri_block
    ntile = -(-H // tile_rows)
    xs = torch.arange(W, dtype=torch.float32, device=dev) + 0.5
    depth = torch.full((ntile * tile_rows, W), BIG, dtype=torch.float32, device=dev)
    tid = torch.full((ntile * tile_rows, W), -1, dtype=torch.int64, device=dev)
    for t in range(ntile):
        ys = t * tile_rows + torch.arange(tile_rows, dtype=torch.float32, device=dev) + 0.5
        px = xs[None, :].expand(tile_rows, W).reshape(-1, 1)
        py = ys[:, None].expand(tile_rows, W).reshape(-1, 1)
        d = depth[t * tile_rows:(t + 1) * tile_rows].reshape(-1)
        i = tid[t * tile_rows:(t + 1) * tile_rows].reshape(-1)
        for b in range(nblk):
            s = slice(b * tri_block, (b + 1) * tri_block)
            ax, ay, bx, by = sx[s, 0], sy[s, 0], sx[s, 1], sy[s, 1]
            cx, cy = sx[s, 2], sy[s, 2]
            za, zb, zc = sz[s, 0], sz[s, 1], sz[s, 2]
            area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
            big = torch.abs(area) > 1e-12
            inv_area = torch.where(big, 1.0 / area, 0.0)
            e0 = (cx - bx) * (py - by) - (cy - by) * (px - bx)
            e1 = (ax - cx) * (py - cy) - (ay - cy) * (px - cx)
            e2 = (bx - ax) * (py - ay) - (by - ay) * (px - ax)
            w0, w1, w2 = e0 * inv_area, e1 * inv_area, e2 * inv_area
            z = (w0 * za + w1 * zb) + w2 * zc
            cov = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & ok[s] & big & (z > 0) & (z < 1)
            z = torch.where(cov, z, BIG)
            zbest, best = torch.min(z, dim=1)
            better = zbest < d
            d.copy_(torch.where(better, zbest, d))
            i.copy_(torch.where(better, b * tri_block + best, i))
    return depth[:H], torch.where(tid[:H] >= T, -1, tid[:H]).to(torch.int32)


def raster_screen(sx, sy, sz, ok, W: int, H: int, attr_tab=None):
    """Z-buffer over screen-space triangles (already clipped): sx, sy, sz
    (T, 3), ok (T,). Returns (depth (H, W), tid (H, W) int32, -1 =
    background), and gbuf (H, W, A) = attr_tab[tid] (zeros on background)
    when ``attr_tab`` (T, A) is given."""
    if W % 128 == 0 and H % 32 == 0:
        return rasterize_ids_tiled(sx, sy, sz, ok, W, H, attr_tab=attr_tab)
    depth, tid = _sweep(sx, sy, sz, ok, W, H)
    if attr_tab is None:
        return depth, tid
    gbuf = torch.where((tid >= 0)[..., None], attr_tab.to(torch.float32)[tid.clamp(min=0).long()],
                       0.0)
    return depth, tid, gbuf


def rasterize_ids(tris_world, valid, mvp, W: int, H: int, ortho: bool = False):
    """Z-buffer raster with near-plane clipping. Returns (depth (H, W),
    tri_id (H, W) int32 in the caller's order, -1 = background).
    ``ortho``: the projection has w ≡ 1, so the near clip is skipped."""
    T = tris_world.shape[0]
    clip = _project(tris_world, mvp.to(tris_world.device))
    clip2, ok2 = (clip, valid) if ortho else near_clip(clip, valid)
    sx, sy, sz, _ = _screen(clip2, W, H)
    depth, tid = raster_screen(sx, sy, sz, ok2, W, H)
    return depth, torch.where(tid >= 0, tid % T, -1)


def _light_uv(wpos, light_vp, shadow_size: int):
    """Light-space texel coordinates and depth of world points."""
    lclip = _dot4(light_vp, _homogeneous(wpos))
    lx = (lclip[..., 0] + 1.0) * 0.5 * shadow_size
    ly = (1.0 - lclip[..., 1]) * 0.5 * shadow_size
    return lx, ly, lclip[..., 2]


def _texel(v, n: int):
    """clip(int32(v), 0, n - 1), truncating toward zero, with NaN → 0 and
    out-of-range values saturating as XLA's conversion does."""
    v = torch.where(torch.isnan(v), 0.0, v)
    return torch.clamp(torch.clamp(v, -1.0, float(n)).to(torch.int64), 0, n - 1)


def _pcf_taps(smap, lx, ly, shadow_size: int):
    """(..., 9) shadow-map taps around each texel, edge-clamped, in
    (dy, dx) order -1, 0, 1 (the JAX package's pre-shifted stack)."""
    ix, iy = _texel(lx, shadow_size), _texel(ly, shadow_size)
    taps = [smap[torch.clamp(iy + dy, 0, shadow_size - 1), torch.clamp(ix + dx, 0, shadow_size - 1)]
            for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    return torch.stack(taps, dim=-1)


def _shade_deferred(inv_vp, light_vp, ldir, depth, tid2, sdepth, gbuf, W: int, H: int,
                    shadow_size: int, ambient: float, bias: float):
    """Flat shading from the depth, id and G-buffer images alone. ``gbuf``
    (H, W, 7) = [n̂ (3), color (3), n̂·v0]; the world position is the pixel
    ray's intersection with the winner's plane; the 9-tap PCF compares
    int16 depths quantized as round(clip(v, -1, 2) · 1e4) (half to even).
    ``inv_vp`` is inv(cam_vp) and ``ldir`` the unit vector toward the
    light, both on the device."""
    dev = depth.device
    hit = tid2 >= 0
    n = _unit(gbuf[..., 0:3])
    base = gbuf[..., 3:6]
    pn, pd = gbuf[..., 0:3], gbuf[..., 6]

    px = torch.arange(W, dtype=torch.float32, device=dev)[None, :] + 0.5
    py = torch.arange(H, dtype=torch.float32, device=dev)[:, None] + 0.5
    ndc_x = (px * (2.0 / W) - 1.0).expand(H, W)
    ndc_y = (1.0 - py * (2.0 / H)).expand(H, W)
    ndc_h = torch.stack([ndc_x, ndc_y, torch.zeros_like(ndc_x), torch.ones_like(ndc_x)], -1)
    world_h = _dot4(inv_vp, ndc_h)
    wdiv = world_h[..., 3]
    wdiv = torch.where(torch.abs(wdiv) > 1e-12, wdiv, 1.0)
    x0 = world_h[..., :3] / wdiv[..., None]
    # The ray h₃·x0 − h[:3] (h = inv_vp @ e_z) is ∝ x0 − eye for a
    # perspective map; the ray-plane form ignores its scale and sign.
    h = inv_vp[:, 2]
    ray = h[3] * x0 - h[:3]
    ndot0 = dot3(pn, x0)
    ndotr = dot3(pn, ray)
    tstar = (pd - ndot0) / torch.where(torch.abs(ndotr) > 1e-12, ndotr, 1.0)
    wpos = x0 + tstar[..., None] * ray

    nl = dot3(n, ldir)
    diffuse = torch.clamp(nl, min=0.0)
    slope = 1.0 / torch.clamp(torch.abs(nl), min=0.15)
    lx, ly, lz = _light_uv(wpos, light_vp, shadow_size)
    QS = 10000.0
    sq = torch.round(torch.clamp(sdepth, -1.0, 2.0) * QS).to(torch.int16)
    sd9 = _pcf_taps(sq, lx, ly, shadow_size)
    qlz = torch.round(torch.clamp(lz - bias * slope, -1.0, 2.0) * QS).to(torch.int16)
    shadow = div_rn((qlz[..., None] <= sd9).to(torch.float32).sum(-1), 9.0)
    lit = base * (ambient + diffuse * shadow)[..., None]
    bg = torch.tensor(BACKGROUND, dtype=torch.float32, device=dev)
    return torch.clamp(torch.where(hit[..., None], lit, bg), 0.0, 1.0), depth


def _host_light(light_dir) -> torch.Tensor:
    """The unit vector toward the light, built on the CPU."""
    return normalize(-torch.as_tensor(light_dir, dtype=torch.float32).detach().cpu())


@torch.no_grad()
def render_scene(tris_world, valid, colors, cam_vp, light_vp, light_dir, W: int = 512,
                 H: int = 512, shadow_size: int = 1024, cfg=None, wireframe: bool = False,
                 normals=None):
    """Full two-pass frame on ``tris_world``'s device. colors (T, 3) base
    color per triangle; cam_vp, light_vp (4, 4) and light_dir (3,) host
    values (built on the CPU, copied here); normals: optional (T, 3, 3)
    per-corner normals for smooth shading. Returns (image (H, W, 3) in
    [0, 1], depth (H, W))."""
    ambient = 0.08 if cfg is None else cfg.ambient
    bias = 2e-3 if cfg is None else cfg.depth_bias
    dev = tris_world.device
    T = tris_world.shape[0]
    cam_host = torch.as_tensor(cam_vp, dtype=torch.float32).detach().cpu()
    cam = cam_host.to(dev)
    lvp = torch.as_tensor(light_vp, dtype=torch.float32).to(dev)
    ldir = _host_light(light_dir).to(dev)

    # Pass 1: shadow depth (ortho, so no near clip).
    sdepth, _ = rasterize_ids(tris_world, valid, lvp, shadow_size, shadow_size, ortho=True)
    # Pass 2: camera depth and ids.
    clip = _project(tris_world, cam)
    n_t = _unit(_cross(tris_world[:, 1] - tris_world[:, 0], tris_world[:, 2] - tris_world[:, 0]))

    if normals is None and not wireframe:
        # Deferred flat shading: near-clipped second pieces in a small pool,
        # the winner's [n̂, color, n̂·v0] G-buffer from the raster.
        clip_p, ok_p, src_p = _near_clip_pooled(clip, valid)
        sxp, syp, szp, _ = _screen(clip_p, W, H)
        d_t = dot3(n_t, tris_world[:, 0])[:, None]
        attr_tab = torch.cat([n_t, colors.to(torch.float32), d_t], dim=1)[src_p]
        depth, tid2, gbuf = raster_screen(sxp, syp, szp, ok_p, W, H, attr_tab=attr_tab)
        inv_vp = torch.linalg.inv(cam_host).to(dev)
        return _shade_deferred(inv_vp, lvp, ldir, depth, tid2, sdepth, gbuf, W, H,
                               shadow_size, ambient, bias)

    clip2, world2, ok2 = _near_clip_full(clip, valid, tris_world)
    sx, sy, sz, inv_w = _screen(clip2, W, H)
    depth, tid2 = raster_screen(sx, sy, sz, ok2, W, H)
    hit = tid2 >= 0
    t2 = torch.clamp(tid2, 0, 2 * T - 1).long()
    parts = [world2.reshape(2 * T, 9), sx, sy, inv_w, n_t.repeat(2, 1),
             colors.to(torch.float32).repeat(2, 1)]
    if normals is not None:
        # Near-clip second pieces take the flat normal at every corner.
        flat3 = n_t[:, None, :].expand(T, 3, 3)
        parts.append(torch.cat([normals.to(torch.float32), flat3]).reshape(2 * T, 9))
    pa = torch.cat(parts, dim=1)[t2]
    tri = pa[..., 0:9].reshape(pa.shape[:-1] + (3, 3))
    ax, bx, cx = pa[..., 9], pa[..., 10], pa[..., 11]
    ay, by, cy = pa[..., 12], pa[..., 13], pa[..., 14]
    iw = pa[..., 15:18]
    n = pa[..., 18:21]
    base = pa[..., 21:24]

    px = torch.arange(W, dtype=torch.float32, device=dev)[None, :] + 0.5
    py = torch.arange(H, dtype=torch.float32, device=dev)[:, None] + 0.5
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    inv_area = torch.where(torch.abs(area) > 1e-12, 1.0 / area, 0.0)
    w0 = ((cx - bx) * (py - by) - (cy - by) * (px - bx)) * inv_area
    w1 = ((ax - cx) * (py - cy) - (ay - cy) * (px - cx)) * inv_area
    w2 = 1.0 - w0 - w1
    p0, p1, p2 = w0 * iw[..., 0], w1 * iw[..., 1], w2 * iw[..., 2]
    denom = (p0 + p1) + p2
    denom = torch.where(torch.abs(denom) > 1e-12, denom, 1.0)[..., None]
    wpos = ((tri[..., 0, :] * p0[..., None] + tri[..., 1, :] * p1[..., None])
            + tri[..., 2, :] * p2[..., None]) / denom
    if normals is not None:
        # Perspective-correct normal interpolation at the pixel.
        vn = pa[..., 24:33].reshape(pa.shape[:-1] + (3, 3))
        n = _unit(((vn[..., 0, :] * p0[..., None] + vn[..., 1, :] * p1[..., None])
                   + vn[..., 2, :] * p2[..., None]) / denom)

    nl = dot3(n, ldir)
    diffuse = torch.clamp(nl, min=0.0)
    slope = 1.0 / torch.clamp(torch.abs(nl), min=0.15)
    lx, ly, lz = _light_uv(wpos, lvp, shadow_size)
    sd9 = _pcf_taps(sdepth, lx, ly, shadow_size)
    shadow = div_rn(((lz - bias * slope)[..., None] <= sd9).to(torch.float32).sum(-1), 9.0)
    lit = base * (ambient + diffuse * shadow)[..., None]
    if wireframe:
        # Edge overlay from the screen barycentrics.
        edge = torch.minimum(torch.minimum(w0, w1), w2)
        lit = torch.where((edge < 0.03)[..., None], lit * 0.15, lit)
    bg = torch.tensor(BACKGROUND, dtype=torch.float32, device=dev)
    return torch.clamp(torch.where(hit[..., None], lit, bg), 0.0, 1.0), depth
