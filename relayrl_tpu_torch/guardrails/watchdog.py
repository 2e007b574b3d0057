"""Divergence watchdog: device-side health probes + rolling-window
detectors over the learner's update stream.

Counterpart of :mod:`relayrl_tpu.guardrails.watchdog`: :class:`Trip` and
:class:`DivergenceWatchdog` are copies (pure Python over resolved
metrics); :class:`GuardProbes` is written in torch.

**Probes are observers, never perturbations.** The update itself is
untouched (guardrails-on params are BIT-identical to guardrails-off);
two small separate passes run around each dispatch instead:

* ``pre_update``  — a device copy of the probe target's float leaves
  (only when the update-norm probe is enabled), queued BEFORE the update:
  Adam moves the port's params in place, so this copy is the only record
  of the old values (the JAX package copies ahead of its donating update
  for the same reason);
* ``post_update`` — nonfinite-element count, global param L2 norm, and
  (with the copy) the update-step L2 norm ``||new - old||`` — the
  grad-norm proxy that needs no access to the update's internals.

Both read the float leaves as ONE flat float32 vector (one ``torch.cat``),
so a probe costs a fixed handful of launches per update whatever the
number of leaves. The three results are **0-d device tensors** merged
into the update's metrics dict: they are queued on the learner's stream
behind the update, ride the same in-flight window as its metrics, and
are read to the host in the window's single stacked device-to-host copy
at the fence (:class:`~relayrl_tpu_torch.runtime.pipeline.LazyMetrics`)
— no host sync on the dispatch path.

The :class:`DivergenceWatchdog` consumes resolved probes plus two host
signals — per-update loss (spike detector over a rolling median) and
per-trajectory reward (collapse detector over a rolling mean) — and
turns threshold crossings into a :class:`Trip` the server's rollback
path consumes (docs/operations.md "Training-health guardrails").
"""

from __future__ import annotations

import statistics
import threading
from collections import deque
from dataclasses import dataclass

#: Reserved metric keys the probes merge into each update's metrics.
PROBE_NONFINITE = "GuardNonfiniteParams"
PROBE_PARAM_NORM = "GuardParamNorm"
PROBE_UPDATE_NORM = "GuardUpdateNorm"

TRIP_SIGNALS = ("nonfinite_params", "param_norm", "update_norm",
                "loss_nonfinite", "loss_spike", "reward_collapse",
                "publish_nonfinite")


@dataclass(frozen=True)
class Trip:
    """One watchdog firing: what crossed which line, at which update."""

    signal: str
    value: float
    threshold: float
    dispatch_count: int | None = None

    def to_dict(self) -> dict:
        return {"signal": self.signal, "value": self.value,
                "threshold": self.threshold,
                "dispatch_count": self.dispatch_count}


class GuardProbes:
    """The two observer passes. Float leaves only; integer/bool leaves
    (step counters) carry no divergence signal. Norms accumulate in
    float32 — a sumsq overflow needs leaf values beyond ~1e19, itself a
    divergence the nonfinite probe then reports as inf.

    The probe target is an ``nn.Module`` (its parameters, the flax params
    tree's leaves), a tensor, or a nested dict/list of tensors or numpy
    arrays."""

    def __init__(self, update_norm: bool = True):
        self.update_norm = bool(update_norm)

    @staticmethod
    def _float_leaves(tree) -> list:
        import numpy as np
        import torch

        if isinstance(tree, torch.nn.Module):
            # A module placed on a mesh is probed whole, in its unplaced
            # leaf order (its split parameters gathered).
            from relayrl_tpu_torch.weights import logical_state

            leaves = list(logical_state(tree).values())
        elif isinstance(tree, dict):
            leaves = [leaf for value in tree.values()
                      for leaf in GuardProbes._float_leaves(value)]
        elif isinstance(tree, (list, tuple)):
            leaves = [leaf for value in tree
                      for leaf in GuardProbes._float_leaves(value)]
        elif isinstance(tree, torch.Tensor):
            leaves = [tree]
        elif isinstance(tree, (np.ndarray, np.generic)):
            arr = np.asarray(tree)
            leaves = ([torch.from_numpy(arr.astype(np.float32))]
                      if arr.dtype.kind in "fV" else [])
        else:
            leaves = []
        return [leaf for leaf in leaves
                if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()]

    @classmethod
    def _flat(cls, tree):
        """Every float leaf as one flat float32 vector (one ``cat``
        launch; None without float leaves)."""
        import torch

        leaves = cls._float_leaves(tree)
        if not leaves:
            return None
        with torch.no_grad():
            return torch.cat([leaf.detach().reshape(-1).float()
                              for leaf in leaves])

    def pre_update(self, params):
        """A flat float32 copy of the float leaves, queued before the
        update moves them in place; None when the update-norm probe is
        off."""
        if not self.update_norm:
            return None
        return self._flat(params)  # cat always writes a fresh tensor

    def post_update(self, old_copy, new_params) -> dict:
        """Probe the post-update params; returns 0-d device tensors under
        the reserved Guard* keys (queued, not read)."""
        import torch

        new = self._flat(new_params)
        with torch.no_grad():
            if new is None:
                nonfinite = torch.zeros((), dtype=torch.int32)
                norm = torch.zeros((), dtype=torch.float32)
            else:
                nonfinite = torch.logical_not(torch.isfinite(new)).sum(
                    dtype=torch.int32)
                norm = torch.linalg.vector_norm(new)
            out = {PROBE_NONFINITE: nonfinite, PROBE_PARAM_NORM: norm}
            if old_copy is None:
                return out
            if new is None:
                delta = torch.zeros((), dtype=torch.float32)
            else:
                delta = torch.linalg.vector_norm(new - old_copy)
            out[PROBE_UPDATE_NORM] = delta
        return out


class DivergenceWatchdog:
    """Rolling-window trip logic over resolved probes + host signals.

    Thread model: ``observe_dispatch``/``poll`` run on the learner
    thread only; ``observe_reward`` runs on staging/transport threads;
    ``trip_external`` may fire from the publisher thread — the small
    lock covers the shared deques and the external-trip slot, and no
    device fence ever happens under it.
    """

    def __init__(self, max_param_norm: float = 0.0,
                 max_update_norm: float = 0.0,
                 loss_spike_factor: float = 0.0, loss_window: int = 16,
                 loss_key: str = "auto",
                 reward_collapse_drop: float = 0.0,
                 reward_window: int = 32):
        from relayrl_tpu_torch import telemetry

        self.max_param_norm = float(max_param_norm or 0.0)
        self.max_update_norm = float(max_update_norm or 0.0)
        self.loss_spike_factor = float(loss_spike_factor or 0.0)
        self.loss_window = max(4, int(loss_window))
        self.loss_key = loss_key
        self.reward_collapse_drop = float(reward_collapse_drop or 0.0)
        self.reward_window = max(4, int(reward_window))
        self._lock = threading.Lock()
        self._pending: deque = deque()   # (dispatch_count, metrics mapping)
        self._losses: deque = deque(maxlen=self.loss_window)
        self._rewards: deque = deque(maxlen=self.reward_window)
        self._best_reward_mean: float | None = None
        self._external: Trip | None = None
        self._resolved_ok = True
        self.trips_total = 0
        self.last_trip: Trip | None = None
        reg = telemetry.get_registry()
        self._m_trips = {
            sig: reg.counter("relayrl_guard_watchdog_trips_total",
                             "divergence watchdog firings",
                             {"signal": sig})
            for sig in TRIP_SIGNALS
        }

    # -- feeds --
    def observe_dispatch(self, dispatch_count: int, metrics) -> None:
        """Queue one dispatched update's (lazy) metrics for evaluation
        once the in-flight window fences it. Learner thread only."""
        with self._lock:
            self._pending.append((dispatch_count, metrics))

    def observe_reward(self, total_reward: float) -> None:
        """One validated trajectory's total reward (staging threads)."""
        with self._lock:
            self._rewards.append(float(total_reward))

    def trip_external(self, signal: str, value: float = float("nan"),
                      threshold: float = 0.0) -> None:
        """An out-of-band trip (the publish gate's nonfinite detection,
        fired from the publisher thread); the learner thread's next
        :meth:`poll` surfaces it."""
        with self._lock:
            if self._external is None:
                self._external = Trip(signal, value, threshold)

    # -- evaluation --
    def _loss_of(self, metrics) -> float | None:
        key = self.loss_key
        if key == "auto":
            for candidate in ("LossPi", "LossQ", "Loss", "LossQ1"):
                if candidate in metrics:
                    key = candidate
                    break
            else:
                return None
        try:
            value = metrics.get(key)
            return None if value is None else float(value)
        except Exception:
            return None

    def _check_resolved(self, dc: int, metrics) -> Trip | None:
        import math

        def read(key):
            try:
                value = metrics.get(key)
                return None if value is None else float(value)
            except Exception:
                return None

        nonfinite = read(PROBE_NONFINITE)
        if nonfinite is not None and nonfinite > 0:
            return Trip("nonfinite_params", nonfinite, 0.0, dc)
        norm = read(PROBE_PARAM_NORM)
        if norm is not None and not math.isfinite(norm):
            # sumsq overflow: params beyond float32 range — divergence.
            return Trip("param_norm", norm, self.max_param_norm, dc)
        if (self.max_param_norm > 0 and norm is not None
                and norm > self.max_param_norm):
            return Trip("param_norm", norm, self.max_param_norm, dc)
        delta = read(PROBE_UPDATE_NORM)
        if (self.max_update_norm > 0 and delta is not None
                and (delta > self.max_update_norm
                     or not math.isfinite(delta))):
            return Trip("update_norm", delta, self.max_update_norm, dc)
        loss = self._loss_of(metrics)
        if loss is not None:
            if not math.isfinite(loss):
                return Trip("loss_nonfinite", loss, 0.0, dc)
            if self.loss_spike_factor > 0:
                with self._lock:
                    history = list(self._losses)
                    self._losses.append(abs(loss))
                if len(history) >= self.loss_window // 2:
                    baseline = statistics.median(history)
                    bar = self.loss_spike_factor * max(baseline, 1e-8)
                    if abs(loss) > bar:
                        return Trip("loss_spike", abs(loss), bar, dc)
            else:
                with self._lock:
                    self._losses.append(abs(loss))
        return None

    def _check_rewards(self) -> Trip | None:
        if self.reward_collapse_drop <= 0:
            return None
        with self._lock:
            rewards = list(self._rewards)
        if len(rewards) < self.reward_window:
            return None
        mean = sum(rewards) / len(rewards)
        if self._best_reward_mean is None or mean > self._best_reward_mean:
            self._best_reward_mean = mean
            return None
        drop = self._best_reward_mean - mean
        if drop > self.reward_collapse_drop:
            return Trip("reward_collapse", mean, self.reward_collapse_drop)
        return None

    def poll(self, fenced_count: int) -> Trip | None:
        """Resolve every pending probe whose update the in-flight window
        has fenced (resolution is free post-fence — the LazyMetrics
        deferral) and evaluate all detectors. Returns the first Trip, or
        None. Learner thread only."""
        with self._lock:
            external, self._external = self._external, None
        trip = external
        while trip is None:
            with self._lock:
                if not self._pending or self._pending[0][0] > fenced_count:
                    break
                dc, metrics = self._pending.popleft()
            trip = self._check_resolved(dc, metrics)
            if trip is None:
                with self._lock:
                    self._resolved_ok = True
        if trip is None:
            trip = self._check_rewards()
        if trip is not None:
            self._fire(trip)
        return trip

    def _fire(self, trip: Trip) -> None:
        from relayrl_tpu_torch import telemetry

        with self._lock:
            self.trips_total += 1
            self.last_trip = trip
            self._resolved_ok = False
        self._m_trips.get(trip.signal, self._m_trips["nonfinite_params"]) \
            .inc()
        telemetry.emit("watchdog_trip", **trip.to_dict())
        print(f"[guardrails] WATCHDOG TRIP: {trip.signal} "
              f"value={trip.value:.6g} threshold={trip.threshold:.6g}",
              flush=True)

    def healthy(self) -> bool:
        """True when the most recently RESOLVED probes were clean and no
        trip is pending — the checkpoint plane's healthy-at-save tag.
        Deliberately conservative: an un-polled external trip, any
        un-cleared firing, or a probe still awaiting resolution reads
        unhealthy — a pending probe may be the one carrying the NaN, so
        tagging through it would let restore_latest_healthy hand back
        poisoned params."""
        with self._lock:
            return (self._resolved_ok and self._external is None
                    and not self._pending)

    def reset_after_rollback(self) -> None:
        """Drop every pending probe and detector window — they describe
        the rolled-back line of history — and re-arm."""
        with self._lock:
            self._pending.clear()
            self._losses.clear()
            self._rewards.clear()
            self._best_reward_mean = None
            self._external = None
            self._resolved_ok = True

    def accounting(self) -> dict:
        with self._lock:
            return {
                "trips_total": self.trips_total,
                "last_trip": (self.last_trip.to_dict()
                              if self.last_trip else None),
                "pending_probes": len(self._pending),
            }


__all__ = ["GuardProbes", "DivergenceWatchdog", "Trip", "TRIP_SIGNALS",
           "PROBE_NONFINITE", "PROBE_PARAM_NORM", "PROBE_UPDATE_NORM"]
