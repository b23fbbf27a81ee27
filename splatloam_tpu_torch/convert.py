"""Surfel pool <-> numpy, so another implementation's state can be loaded.

The JAX package's ``Surfels``/``AdamState`` map onto dicts of numpy arrays
(field names of ``SurfelParams``); these functions build the port's pool
from such dicts and back.
"""
from __future__ import annotations

import numpy as np
import torch

from .model.surfels import (AdamState, SurfelParams, Surfels,
                            adam_step_count)


def _params(d: dict, device) -> SurfelParams:
    return SurfelParams(*(torch.tensor(np.array(d[k]), dtype=torch.float32,
                                       device=device)
                          for k in SurfelParams._fields))


def surfels_from_numpy(params: dict, active, adam: dict | None,
                       device) -> tuple[Surfels, AdamState | None]:
    """params: {xyz, log_scale, quat, logit_opacity}; active [C] bool;
    adam: {"mu": params-like, "nu": params-like, "step": int} or None;
    the step becomes the port's 0-d int32 tensor on ``device``."""
    surfels = Surfels(params=_params(params, device),
                      active=torch.tensor(np.array(active, bool),
                                          device=device))
    state = None
    if adam is not None:
        state = AdamState(mu=_params(adam["mu"], device),
                          nu=_params(adam["nu"], device),
                          step=adam_step_count(int(adam["step"]), device))
    return surfels, state


def _to_numpy(p: SurfelParams) -> dict:
    return {k: getattr(p, k).detach().cpu().numpy()
            for k in SurfelParams._fields}


def surfels_to_numpy(surfels: Surfels, adam: AdamState | None = None):
    """-> (params dict, active [C] bool, adam dict or None, its step a
    Python int)."""
    state = None
    if adam is not None:
        state = {"mu": _to_numpy(adam.mu), "nu": _to_numpy(adam.nu),
                 "step": int(adam.step)}
    return (_to_numpy(surfels.params), surfels.active.cpu().numpy(), state)
