"""In-process actor↔learner loop.

Counterpart of :mod:`relayrl_tpu.runtime.local_runner`: wires an env →
policy step → epoch buffer → learner update with no sockets at all, the
loop through which the repo's goldens and quickstart train. The actor and
the learner run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Mapping

import numpy as np

from relayrl_tpu_torch.algorithms import build_algorithm
from relayrl_tpu_torch.runtime.agent import coerce_env_action, greedy_episodes
from relayrl_tpu_torch.runtime.policy_actor import PolicyActor
from relayrl_tpu_torch.types.trajectory import deserialize_actions


class LocalRunner:
    """Single-process trainer: env steps feed the algorithm directly.

    The actor still goes through the *wire codec* (serialize → deserialize on
    episode hand-off) so the exact bytes that would cross the network are
    exercised every episode. ``device`` places both the learner and the
    actor (default: the GPU).
    """

    def __init__(
        self,
        env,
        algorithm_name: str = "REINFORCE",
        config_path: str | None = None,
        env_dir: str | None = None,
        seed: int | None = None,
        device=None,
        **hyperparams,
    ):
        self.env = env
        obs_dim = int(np.prod(env.observation_space.shape))
        act_dim = (
            env.action_space.n
            if hasattr(env.action_space, "n")
            else int(np.prod(env.action_space.shape))
        )
        # An explicit seed seeds BOTH sides: the actor's sampling stream
        # below and the learner's init/update stream (forwarded as the
        # algorithm `seed` hyperparam, which trumps any config-file seed
        # — explicit overrides always win over config params in
        # build_algorithm) — so `--hp seed=N` runs land in `..._sN` log
        # dirs and vary the whole pipeline, not just action sampling.
        # Only `seed_salt` is independent of this seed: the learner folds
        # in that per-process salt (default pid, mirroring the
        # reference's `seed + 10000*pid`), so two runs at the same seed
        # are independent unless seed_salt is pinned too.
        if seed is not None:
            hyperparams.setdefault("seed", seed)
        self.algorithm = build_algorithm(
            algorithm_name,
            env_dir=env_dir,
            config_path=config_path,
            obs_dim=obs_dim,
            act_dim=int(act_dim),
            device=device,
            **hyperparams,
        )
        self._episode_bytes: list[bytes] = []
        # On-policy epoch buffers expose length buckets; the off-policy step
        # replay ring has none — cap trajectories at a fixed horizon there.
        # (PolicyActor adds marker headroom on top of this cap.)
        buckets = getattr(self.algorithm.buffer, "buckets", None)
        self.actor = PolicyActor(
            self.algorithm.bundle(),
            max_traj_length=buckets[-1] if buckets else 1000,
            on_send=self._episode_bytes.append,
            seed=0 if seed is None else seed,
            device=device,
        )
        self.seed = seed
        self.updates = 0
        # Rolling window across train() calls: per-call windows can be
        # as short as a handful of episodes for off-policy families
        # (updates land ~every episode), letting an early-stop target
        # trigger on a lucky streak. 50 episodes is the SpinningUp-style
        # smoothing horizon.
        self._recent_returns: deque[float] = deque(maxlen=50)

    def run_episode(self, max_steps: int = 1000) -> tuple[float, int]:
        obs, _ = self.env.reset(seed=None)
        ep_ret, ep_len = 0.0, 0
        reward = 0.0
        terminated = truncated = False
        for _ in range(max_steps):
            record = self.actor.request_for_action(obs, reward=reward)
            obs, reward, terminated, truncated, _ = self.env.step(
                self._to_env_action(record.act)
            )
            ep_ret += float(reward)
            ep_len += 1
            if terminated or truncated:
                break
        # Ending by time limit (env truncation or the max_steps cap here)
        # is not a terminal state: ship the post-step obs so value targets
        # bootstrap through it. A genuine terminal takes precedence even if
        # it coincides with the time limit (Gymnasium allows both True).
        time_limited = not terminated
        self.actor.flag_last_action(
            reward, truncated=time_limited,
            final_obs=obs if time_limited else None)

        # Hand the wire bytes to the learner exactly as the server would.
        for buf in self._episode_bytes:
            actions = deserialize_actions(buf)
            if self.algorithm.receive_trajectory(actions):
                self.updates += 1
                self.actor.maybe_swap(self.algorithm.bundle())
        self._episode_bytes.clear()
        return ep_ret, ep_len

    def train(self, epochs: int = 10, max_steps: int = 1000) -> dict[str, Any]:
        """Run until ``epochs`` learner updates have happened."""
        returns: list[float] = []
        target_updates = self.updates + epochs
        while self.updates < target_updates:
            ep_ret, _ = self.run_episode(max_steps)
            returns.append(ep_ret)
            self._recent_returns.append(ep_ret)
        return {
            "episodes": len(returns),
            "updates": self.updates,
            # Mean over the PERSISTENT 50-episode window, not just this
            # call's episodes — a train(epochs=5) chunk may contain only
            # ~5 episodes for off-policy families, and early-stop
            # targets read this value (a 5-episode window stops on luck;
            # the committed SAC golden's first run did exactly that).
            "avg_return_last_window": float(np.mean(self._recent_returns)),
            "returns": returns,
        }

    def evaluate(self, episodes: int = 10, max_steps: int = 1000) -> dict:
        """Greedy evaluation between training episodes: probes the CURRENT
        policy deterministically without recording anything to the
        trajectory (nothing reaches the learner buffer). Refuses to run
        mid-episode (run_episode always closes its episode, so calling
        between episodes is always safe)."""
        returns = greedy_episodes(self.actor, self.env, episodes, max_steps)
        return {
            "episodes": episodes,
            "avg_return": float(np.mean(returns)),
            "returns": returns,
        }

    def _to_env_action(self, act: np.ndarray):
        return coerce_env_action(act)


def reward_threshold_reached(result: Mapping[str, Any], threshold: float) -> bool:
    return result["avg_return_last_window"] >= threshold
