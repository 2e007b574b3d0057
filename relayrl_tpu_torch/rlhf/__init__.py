"""RLHF workload plane: the generate → score → update dataflow.

Counterpart of :mod:`relayrl_tpu.rlhf`.

* :mod:`relayrl_tpu_torch.rlhf.scorers` — the pluggable terminal-boundary
  scorer interface with two built-ins (programmatic CI scorer, frozen
  transformer reward model);
* :mod:`relayrl_tpu_torch.rlhf.scheduler` — the dataflow scheduler wiring
  token generation through the actor tiers, decoupled scoring, and
  emission into the spool/seq/ingest machinery; the lag between behavior
  and learner versions is corrected by the IMPALA learner's V-trace
  (``algorithms/impala.py`` over ``ops/vtrace.py``) from the behavior
  log-probs recorded per token at generation time.

The environment half lives in the env registries (``TokenGen-v0``:
``envs/tokengen.py`` and its device twin), the frozen-layer optimizer
masks in ``algorithms/freeze.py`` (the ``learner.freeze`` knob).
"""

from relayrl_tpu_torch.rlhf.scorers import (  # noqa: F401
    SCORERS,
    ProgrammaticScorer,
    RewardModelScorer,
    make_scorer,
)

__all__ = ["SCORERS", "ProgrammaticScorer", "RewardModelScorer",
           "make_scorer"]
