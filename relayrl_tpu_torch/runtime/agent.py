"""The two agent helpers the local loop uses.

Counterpart of :func:`relayrl_tpu.runtime.agent.coerce_env_action` and
:func:`relayrl_tpu.runtime.agent.greedy_episodes`. The networked ``Agent``
itself is not ported yet.
"""

from __future__ import annotations

import numpy as np


def coerce_env_action(act) -> object:
    """Wire action → what ``env.step`` expects: python scalar for 0-d
    (int for integer dtypes, float otherwise), ndarray for vectors."""
    arr = np.asarray(act)
    if arr.ndim == 0:
        return int(arr) if np.issubdtype(arr.dtype, np.integer) else float(arr)
    return arr


def greedy_episodes(actor, env, episodes: int, max_steps: int = 1000,
                    seed: int | None = None) -> list[float]:
    """The shared deterministic-eval loop: greedy actions, nothing recorded
    or shipped to the learner. Refuses to run mid-episode — a sampling
    episode in flight would be silently corrupted by the window resets
    (finish it with ``flag_last_action`` first); any stale eval serving
    state is cleared up front."""
    if actor.trajectory.get_actions():
        raise RuntimeError(
            "greedy eval requested mid-episode: the current sampling "
            "episode has unsent steps — call flag_last_action first")
    actor.reset_episode()
    returns = []
    for ep in range(episodes):
        obs, _ = env.reset(seed=None if seed is None else seed + ep)
        ep_ret = 0.0
        for _ in range(max_steps):
            act = actor.deterministic_action(obs)
            obs, reward, terminated, truncated, _ = env.step(
                coerce_env_action(act))
            ep_ret += float(reward)
            if terminated or truncated:
                break
        actor.reset_episode()
        returns.append(ep_ret)
    return returns
