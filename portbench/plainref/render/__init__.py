"""Software rasterizer of the port: two passes (shadow depth, then the
camera's z-buffered, shadow-mapped frame) on the triangles' device, the
z-buffer through kernel B11 on the card."""

from plainref.render.raster import render_scene

__all__ = ["render_scene"]
