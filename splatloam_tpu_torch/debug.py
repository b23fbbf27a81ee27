"""Debug / sanitizer subsystem: the port's counterpart of
splatloam_tpu/debug.py, function for function.

  * ``enable_checks`` — process-wide NaN/Inf checks: autograd's anomaly
    mode (a backward that produces NaN raises, naming the forward op),
    and every ``ops/rasterizer/api.render`` / ``render_batch`` checks its
    outputs (``check_outputs``);
  * ``checked`` — runs one suspect function and raises on a non-finite
    output leaf; while it runs, the kernel wrappers check their id lists
    against the pool's row count (checkify's float and index checks);
  * ``finite_state_report`` / ``assert_finite_state`` — every floating
    leaf of a state tree (dicts, lists, tuples and named tuples of
    tensors: the surfel pool, the Adam state) reduced to its count of
    non-finite values on the device, all counts read back in one
    device-to-host copy.  The SLAM loop calls ``assert_finite_state``
    after each map update when ``logging.debug_checks`` is on, so a
    diverged map is caught at the keyframe where it happened;
  * ``audit_donation`` — which arguments a function's outputs reuse the
    storage of (the JAX package audits XLA's buffer donation).

Each check costs one reduction and one device-to-host read where it runs,
and nothing while it is off.
"""
from __future__ import annotations

from typing import Callable, Iterable

import torch

# which non-finite render outputs raise (enable_checks), and how many
# ``checked`` calls are running (the kernels' id checks are on while > 0)
_FLOAT_CHECKS = {"nans": False, "infs": False}
_INDEX_DEPTH = 0


def enable_checks(mode: str = "nans") -> None:
    """Process-wide NaN/Inf checks: "nans", "infs", "all", or "off".

    Turns on autograd's anomaly mode (slow: every op records its stack)
    and makes each render raise ``FloatingPointError`` on a NaN (Inf, or
    either) output; for debugging (the CLI's ``--debug-checks``),
    not production runs.
    """
    if mode not in ("nans", "infs", "all", "off"):
        # validate before changing anything: a bogus mode must not
        # silently clear checks enabled earlier
        raise ValueError(f"unknown check mode {mode!r}")
    torch.autograd.set_detect_anomaly(mode != "off")
    _FLOAT_CHECKS["nans"] = mode in ("nans", "all")
    _FLOAT_CHECKS["infs"] = mode in ("infs", "all")


def check_outputs(tree, what: str) -> None:
    """Under ``enable_checks``: raise ``FloatingPointError`` naming the
    first floating leaf of ``tree`` holding a value the mode checks."""
    nans, infs = _FLOAT_CHECKS["nans"], _FLOAT_CHECKS["infs"]
    if not (nans or infs):
        return
    keys, counts = [], []
    for path, leaf in _leaves(tree):
        if not torch.is_tensor(leaf) or not leaf.is_floating_point():
            continue
        bad = ~torch.isfinite(leaf) if nans and infs else \
            torch.isnan(leaf) if nans else torch.isinf(leaf)
        keys.append(path)
        counts.append(torch.sum(bad, dtype=torch.int32))
    if not keys:
        return
    for key, n in zip(keys, torch.stack(counts).tolist()):
        if n:
            kind = "non-finite" if nans and infs else \
                "NaN" if nans else "Inf"
            raise FloatingPointError(f"{what}: {n} {kind} values in "
                                     f"output {key or '<output>'}")


def checked(fn: Callable) -> Callable:
    """Wrap ``fn`` so that a non-finite output raises host-side.

    The returned callable runs ``fn`` with the kernel wrappers' id checks
    on (an id outside the pool raises ``IndexError`` before its kernel
    launches), then raises ``FloatingPointError`` naming the first output
    leaf that holds a NaN or Inf.
    """
    def run(*args, **kw):
        global _INDEX_DEPTH
        _INDEX_DEPTH += 1
        try:
            out = fn(*args, **kw)
        finally:
            _INDEX_DEPTH -= 1
        for key, n in finite_state_report(out).items():
            if n:
                raise FloatingPointError(
                    f"{n} non-finite values in output {key or '<output>'}")
        return out

    return run


def index_checks_active() -> bool:
    """True while a ``checked`` function runs."""
    return _INDEX_DEPTH > 0


def checks_active() -> bool:
    """True under ``enable_checks`` (a mode other than "off") or while a
    ``checked`` function runs: the checks read values back to the host,
    so the mapper then runs its optimize loop uncaptured."""
    return _FLOAT_CHECKS["nans"] or _FLOAT_CHECKS["infs"] or \
        index_checks_active()


def check_ids(name: str, ids: torch.Tensor, n_rows: int, lo: int = 0,
              mask: torch.Tensor | None = None) -> None:
    """Raise ``IndexError`` if an id of ``ids`` (where ``mask``) lies
    outside [lo, n_rows): one reduction and one read."""
    bad = (ids < lo) | (ids >= n_rows)
    if mask is not None:
        bad = bad & mask
    n = int(torch.sum(bad))
    if n:
        raise IndexError(f"{name}: {n} ids outside [{lo}, {n_rows})")


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


def _storages(tree) -> set:
    return {leaf.untyped_storage().data_ptr() for _, leaf in _leaves(tree)
            if torch.is_tensor(leaf)}


def audit_donation(fn: Callable, args: Iterable, donate_argnums) -> dict:
    """Run ``fn(*args)`` and report, for each argnum of
    ``donate_argnums``, whether its outputs reuse the storage of every
    tensor of that argument (by ``untyped_storage().data_ptr()``): the
    counterpart of the JAX package's check that XLA consumed a donated
    buffer.  A function that returns new tensors (the port's functional
    ``adam_step``) reports False.  Returns {argnum: bool}.
    """
    args = list(args)
    donated = {i: _storages(args[i]) for i in donate_argnums}
    out = _storages(fn(*args))
    return {i: bool(ptrs) and ptrs <= out for i, ptrs in donated.items()}
