"""The ingest finite guard of :mod:`relayrl_tpu.types.columnar`.

Only ``trajectory_is_finite`` is ported, for ``ActionRecord`` lists: the
columnar wire (``DecodedTrajectory``, frames, the native decode) comes
with the distributed-loop slice.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from relayrl_tpu_torch.types.action import ActionRecord, _has_nonfinite


def _all_finite(value) -> bool:
    """False iff the value holds NaN/inf (bfloat16 included: its numpy
    dtype has kind 'V', which ``_has_nonfinite`` checks too)."""
    try:
        return not _has_nonfinite(np.asarray(value))
    except Exception:
        # An unconvertible aux value cannot reach a batch column either
        # (padding's np.asarray fails the same way): inert here.
        return True


def trajectory_is_finite(item: Sequence[ActionRecord]) -> bool:
    """True iff every training-relevant float of the episode is finite:
    rewards, obs, actions and the aux values (``v`` and ``logp_a`` feed the
    losses directly). Action masks are not checked: models read them as
    ``mask > 0``, so a -inf fill is harmless. A NaN here would not crash;
    it would poison the learner state and, through the next publish, every
    actor, so the learner drops such an episode."""
    for a in item:
        if not np.isfinite(a.rew):
            return False
        for value in (a.obs, a.act):
            if value is not None and not _all_finite(value):
                return False
        for v in (a.data or {}).values():
            if isinstance(v, (str, bytes, bool)):
                continue
            if not _all_finite(v):
                return False
    return True
