"""Finiteness checks of the map state (the port's part of
splatloam_tpu/debug.py).

``finite_state_report`` reduces every floating leaf of a state tree
(dicts, lists, tuples and named tuples of tensors: the surfel pool, the
Adam state) to its count of non-finite values on the device, and reads
all counts back in one device-to-host copy.  The SLAM loop calls
``assert_finite_state`` after each map update when
``logging.debug_checks`` is on, so a diverged map is caught at the
keyframe where it happened.
"""
from __future__ import annotations

import torch


def _leaves(tree, path: str = ""):
    """(keystr, leaf) pairs in the JAX package's key notation:
    ``['key']`` for dict entries, ``.field`` for named-tuple fields,
    ``[i]`` for sequence items."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _leaves(getattr(tree, k), f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def finite_state_report(tree, active=None) -> dict:
    """{leaf path: number of non-finite values} over the floating tensor
    leaves of ``tree``.

    ``active`` [C] bool optionally masks the rows of leaves whose leading
    dim is C (the pool's padding rows may hold anything).  The counts
    come back in one device-to-host read.
    """
    keys, counts = [], []
    for path, leaf in _leaves(tree):
        if not torch.is_tensor(leaf) or not leaf.is_floating_point():
            continue
        bad = ~torch.isfinite(leaf)
        if active is not None and leaf.ndim >= 1 and \
                leaf.shape[0] == active.shape[0]:
            bad = bad & active.reshape((-1,) + (1,) * (leaf.ndim - 1))
        keys.append(path)
        counts.append(torch.sum(bad, dtype=torch.int32))
    if not keys:
        return {}
    return dict(zip(keys, torch.stack(counts).tolist()))


def assert_finite_state(tree, active=None, what: str = "state") -> None:
    """Raise (with the per-leaf count table) if any active row is
    non-finite; silent on the happy path."""
    report = finite_state_report(tree, active)
    bad = {k: v for k, v in report.items() if v}
    if bad:
        raise FloatingPointError(f"non-finite values in {what}: {bad}")
