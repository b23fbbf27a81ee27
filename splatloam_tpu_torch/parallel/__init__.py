"""Multi-device mapping over torch.distributed (counterpart of
splatloam_tpu/parallel/)."""
from .mesh import initialize_distributed, make_mesh  # noqa: F401
from .sharded import sharded_train_step  # noqa: F401
