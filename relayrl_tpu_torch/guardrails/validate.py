"""Ingest validation: the semantic trust boundary in front of the learner.

A copy of :mod:`relayrl_tpu.guardrails.validate` (numpy only), except
:func:`params_tree_finite`, which walks the port's host params trees:
nested dicts and lists of numpy arrays or CPU tensors.

The delivery plane guarantees trajectories *arrive* exactly once;
nothing yet guarantees they are *trainable*. A NaN-bearing payload from a
buggy or hostile client would not crash anything — it would silently
poison the learner state and, through the next publish, the whole fleet
(the scenario RLAX's parameter-distribution layer and MindSpeed RL's
per-stage health gates exist for). This module is the single owner of
"is this decoded trajectory safe to stage?":

* **columnar-aware** — a :class:`~relayrl_tpu_torch.types.columnar.
  DecodedTrajectory` is checked with a handful of vectorized numpy ops
  over its column arrays (dtype kind, leading-dim consistency, length
  bound, finiteness), no per-step Python;
* **record-aware** — an ``ActionRecord`` list (the Python decode path)
  is checked per record, reusing the same dtype/finiteness predicates;
* **never raises past the boundary** — any exception inside a check is
  itself a rejection (``reason="validator_error"``), because a hostile
  payload must not be able to weaponize the validator
  (tests/test_guardrails_fuzz.py drives arbitrary/adversarial payloads
  through here and asserts exactly that).

``validate_trajectory`` returns ``None`` for clean trajectories or a
short machine-readable reason string; the server counts every rejection
in ``relayrl_guard_rejected_total{reason}`` and feeds the per-agent
strike book (quarantine.py). Rejection REASONS are part of the operator
surface (docs/operations.md runbook) — keep them stable.
"""

from __future__ import annotations

import numpy as np

#: dtype kinds a wire column may legally carry. 'V' covers ml_dtypes
#: (bfloat16/float8 surface as void-kind structured scalars); object/
#: str/bytes kinds are rejected outright — nothing downstream can
#: batch them, and an object column is the classic smuggling vector.
_OK_KINDS = frozenset("fiub" + "V")

#: Validation rejection reasons (stable operator vocabulary).
REASONS = ("nonfinite", "schema", "shape", "dtype", "length",
           "validator_error")


def _col_ok(arr, n_steps: int | None) -> str | None:
    """One column's structural checks; returns a reason or None."""
    if not isinstance(arr, np.ndarray):
        return "schema"
    if arr.dtype.kind not in _OK_KINDS:
        return "dtype"
    if n_steps is not None and (arr.ndim < 1 or arr.shape[0] != n_steps):
        return "shape"
    return None


def _value_dtype_ok(value) -> bool:
    """A per-record leaf (obs/act/aux) must coerce to a batchable dtype."""
    arr = np.asarray(value)
    return arr.dtype.kind in _OK_KINDS


#: Columns every decoded trajectory must carry: both producers (the
#: native msgpack decoder and the columnar wire encoder) always emit
#: them, and the padding fast path indexes them unguarded — a
#: hand-rolled hostile frame that omits one must shed here, not as a
#: KeyError inside the learner loop.
_REQUIRED_COLS = ("r", "t", "u", "x")


def _validate_decoded(item, max_steps: int) -> str | None:
    from relayrl_tpu_torch.types.columnar import trajectory_is_finite

    n = item.n_steps
    if not isinstance(n, int) or n < 0:
        return "schema"
    if max_steps and n > max_steps:
        return "length"
    for name in _REQUIRED_COLS:
        if name not in item.columns:
            return "schema"
    for name, col in item.columns.items():
        reason = _col_ok(col, n)
        if reason is not None:
            return reason
    for name, col in item.aux.items():
        reason = _col_ok(col, n)
        if reason is not None:
            return reason
    for final in (item.final_obs, item.final_mask):
        if final is not None:
            reason = _col_ok(final, None)
            if reason is not None:
                return reason
    if not trajectory_is_finite(item):
        return "nonfinite"
    return None


def _validate_records(item, max_steps: int) -> str | None:
    from relayrl_tpu_torch.types.action import ActionRecord
    from relayrl_tpu_torch.types.columnar import trajectory_is_finite

    try:
        n = len(item)
    except TypeError:
        return "schema"
    if max_steps and n > max_steps:
        return "length"
    for rec in item:
        if not isinstance(rec, ActionRecord):
            return "schema"
        # rew must be a real scalar (bool is int-kind and harmless);
        # a complex/str rew would die far later, inside batch assembly.
        if not isinstance(rec.rew, (int, float, np.integer, np.floating)):
            return "schema"
        for value in (rec.obs, rec.act, rec.mask):
            if value is not None and not _value_dtype_ok(value):
                return "dtype"
        for value in (rec.data or {}).values():
            if isinstance(value, (str, bytes, bool)):
                continue  # inert on the training path (columnar parity)
            if not _value_dtype_ok(value):
                return "dtype"
    if not trajectory_is_finite(item):
        return "nonfinite"
    return None


def validate_trajectory(item, max_steps: int = 0) -> str | None:
    """``None`` when ``item`` is safe to stage, else a rejection reason.

    ``max_steps`` bounds trajectory length (0 disables the bound);
    callers pass the config's ``max_traj_length`` so an adversarial
    million-step trajectory sheds here instead of exploding the padder.
    Accepts either wire representation (DecodedTrajectory or an
    ActionRecord sequence); anything else is ``"schema"``. Never raises.
    """
    from relayrl_tpu_torch.types.columnar import DecodedTrajectory

    try:
        if isinstance(item, DecodedTrajectory):
            return _validate_decoded(item, max_steps)
        return _validate_records(item, max_steps)
    except Exception:
        # The boundary contract: a payload that can crash a check is by
        # definition not trainable — reject it, never propagate.
        return "validator_error"


def trajectory_reward(item) -> float | None:
    """Total reward of a VALIDATED trajectory (the watchdog's
    reward-collapse feed); None when it cannot be read cheaply."""
    from relayrl_tpu_torch.types.columnar import DecodedTrajectory

    try:
        if isinstance(item, DecodedTrajectory):
            return item.total_reward
        return float(sum(rec.rew for rec in item))
    except Exception:
        return None


def _host_leaves(tree):
    """The leaves of a nested dict/list/tuple tree, in order."""
    if isinstance(tree, dict):
        for value in tree.values():
            yield from _host_leaves(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _host_leaves(value)
    else:
        yield tree


def _as_host_array(leaf) -> np.ndarray:
    """A numpy view of one leaf; a tensor comes over as a numpy array
    (bfloat16 widened to float32, which numpy cannot hold natively)."""
    if type(leaf).__module__.startswith("torch"):
        import torch

        if isinstance(leaf, torch.Tensor):
            tensor = leaf.detach()
            if tensor.dtype == torch.bfloat16:
                tensor = tensor.float()
            return tensor.cpu().numpy()
    return np.asarray(leaf)


def params_tree_finite(host_params) -> bool:
    """True iff every float leaf of a HOST params tree is finite — the
    publish gate's check (runs on the publisher thread; the wire encoder
    walks the same leaves right after, so the marginal cost is one
    vectorized isfinite pass per leaf). Leaves are numpy arrays (the flax
    tree the publisher encodes) or CPU tensors; a bfloat16 numpy leaf
    (ml_dtypes, dtype kind 'V') is widened to float32 first."""
    for leaf in _host_leaves(host_params):
        arr = _as_host_array(leaf)
        if arr.dtype.kind not in "fV":
            continue
        try:
            finite = np.isfinite(arr if arr.dtype.kind == "f"
                                 else arr.astype(np.float32))
        except (TypeError, ValueError):
            continue  # non-numeric void dtype: nothing to check
        if not finite.all():
            return False
    return True


__all__ = ["validate_trajectory", "trajectory_reward",
           "params_tree_finite", "REASONS"]
