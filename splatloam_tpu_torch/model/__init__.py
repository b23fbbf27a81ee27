from .camera import Camera  # noqa: F401
from .frame import Frame  # noqa: F401
from .local_model import LocalModel  # noqa: F401
from .surfels import AdamState, SurfelParams, Surfels  # noqa: F401
