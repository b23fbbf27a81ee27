from . import knn, projection  # noqa: F401
