from .slam import SLAM  # noqa: F401
