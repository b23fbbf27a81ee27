from .api import RenderParams, rasterize, render  # noqa: F401
