"""Collective accounting: per-device send bytes counted at every call.

Counterpart of splatloam_tpu/parallel/stats.py.  The JAX package parses
the collectives out of XLA's compiled HLO; PyTorch has no compiled
program to parse, so the port keeps the same contract by counting: every
collective of parallel/collectives.py records itself here as it runs.

Send-byte conventions (ring algorithms, per participating device), the
JAX package's:
  all-gather       out_bytes * (G-1)/G   (each device sends its shard G-1x)
  all-reduce       2 * bytes * (G-1)/G   (reduce-scatter + all-gather)
  reduce-scatter   out_bytes * (G-1)     (input = G * output)
  collective-permute  out_bytes          (one hop)
plus the two kinds the port uses and the HLO of the JAX programs does not:
  all-to-all       the bytes of the rows this device sends to the others
  broadcast        out_bytes             (a chain: every device but the
                                          last forwards the message once)
with G the process group's size.  Under gloo a CUDA tensor passes through
host memory; those copies (device -> host and back) are counted apart as
staged bytes.

What the count sees that the static HLO of the JAX programs does not: the
count is per call, so a loop's collectives count once per trip.  The
port's programs gather the pool's parameters once per iteration plus once
per rebin block (the binning's gather), and the ring fold is one
all-gather of the bands' segment states (its backward one reduce-scatter)
in place of JAX's n-1 ppermute hops and its closing masked psum.
"""
from __future__ import annotations

import threading
from typing import NamedTuple


class CollectiveOp(NamedTuple):
    kind: str
    out_bytes: int
    group_size: int
    send_bytes: int
    staged_bytes: int = 0


def _send_bytes(kind: str, out_bytes: int, g: int) -> int:
    if g <= 1:
        return 0
    if kind == "all-gather":
        return out_bytes * (g - 1) // g
    if kind == "all-reduce":
        return 2 * out_bytes * (g - 1) // g
    if kind == "reduce-scatter":
        return out_bytes * (g - 1)
    return out_bytes  # collective-permute, broadcast


def _bucket(kind: str, group_size: int) -> str:
    return kind if group_size == 0 else f"{kind}_g{group_size}"


def send_bytes_by_bucket(ops: list[CollectiveOp]) -> dict:
    """Sum per-device send bytes bucketed by (kind, group_size) — the
    granularity at which the hand formulas are stated (group size
    identifies the mesh axis when axis sizes differ)."""
    out: dict = {}
    for op in ops:
        key = _bucket(op.kind, op.group_size)
        out[key] = out.get(key, 0) + op.send_bytes
    return out


_lock = threading.Lock()
_sent: dict[str, int] = {}
_calls: dict[str, int] = {}
_staged = 0


def record(op: CollectiveOp) -> None:
    """Add one collective call to the running totals (the collective
    layer calls this; collectives in an autograd backward run on the
    engine's thread, hence the lock)."""
    global _staged
    key = _bucket(op.kind, op.group_size)
    with _lock:
        _sent[key] = _sent.get(key, 0) + op.send_bytes
        _calls[key] = _calls.get(key, 0) + 1
        _staged += op.staged_bytes


def reset() -> None:
    global _staged
    with _lock:
        _sent.clear()
        _calls.clear()
        _staged = 0


def counted() -> dict:
    """{"send": {bucket: bytes}, "calls": {bucket: n}, "staged": bytes}
    since the last reset()."""
    with _lock:
        return {"send": dict(_sent), "calls": dict(_calls),
                "staged": _staged}
