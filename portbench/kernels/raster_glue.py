"""B11's glue (``csrc/raster.cu``: the key and pack launches around one
``torch.sort``): bytes only."""

MODULE = "surtr_tpu_torch.render.raster_cuda"
ATTR = "_glue_kernel"   # (sx, sy, sz, ok, W, H, attr_tab)


def ops(args, kwargs) -> float:
    return 0.0
