from . import ply, trajectory  # noqa: F401
