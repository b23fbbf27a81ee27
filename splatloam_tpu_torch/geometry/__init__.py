from . import se3, spherical  # noqa: F401
