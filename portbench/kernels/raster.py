"""B11, the tile raster (``csrc/raster.cu``): what rasterizing needs, each
live triangle's edge and depth tests (29 operations) over the pixels of its
screen box inside the image."""

import torch

MODULE = "surtr_tpu_torch.render.raster_cuda"
ATTR = "_kernel"   # (attrs (T, 10 + A): ax ay bx by cx cy az bz cz ok, bbox, rng, nty, ntx, H, W, A, order)
RASTER_OPS = 29


def ops(args, kwargs) -> float:
    attrs, H, W = args[0], int(args[5]), int(args[6])
    a = attrs[:, :6].double()
    ax, ay, bx, by, cx, cy = (a[:, j] for j in range(6))
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    live = (attrs[:, 9] > 0.5) & (area.abs() > 1e-12)
    x0 = torch.clamp(torch.floor(torch.minimum(torch.minimum(ax, bx), cx)), 0, W)
    x1 = torch.clamp(torch.ceil(torch.maximum(torch.maximum(ax, bx), cx)), 0, W)
    y0 = torch.clamp(torch.floor(torch.minimum(torch.minimum(ay, by), cy)), 0, H)
    y1 = torch.clamp(torch.ceil(torch.maximum(torch.maximum(ay, by), cy)), 0, H)
    px = (x1 - x0) * (y1 - y0)
    return float(torch.where(live, px, 0.0).sum()) * RASTER_OPS
