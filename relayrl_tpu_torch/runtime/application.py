"""User-application contract: wire a custom environment to an Agent.

Counterpart of :mod:`relayrl_tpu.runtime.application`, itself the
counterpart of the reference's ``ApplicationAbstract``
(reference: relayrl_framework/src/native/python/_common/_examples/
BaseApplication.py:4-31), the base class its examples subclass to adapt a
domain application to the actor loop. The reference leaves all three
methods abstract, so every user re-writes the request/step/flag loop by
hand (examples/README.md:125-152 shows the canonical shape); here the
loop ships as a concrete, correct-by-default :meth:`drive_episode` that
``run_application`` implementations can delegate to — the same
hot-swap-aware loop the built-in examples and e2e tests use, including
the truncation/final-obs bookkeeping that 1-step TD learners need.
"""

from __future__ import annotations

import abc

from relayrl_tpu_torch.runtime.agent import coerce_env_action


class ApplicationAbstract(abc.ABC):
    """Adapter between a domain application and a RelayRL ``Agent``.

    Subclass and implement the three reference-parity methods; from
    ``run_application``, either write a custom loop against
    ``self.agent`` or call :meth:`drive_episode` per episode with any
    object exposing ``reset() -> raw`` and ``step(act) -> (raw, reward,
    terminated, truncated)``.
    """

    def __init__(self, agent):
        self.agent = agent

    @abc.abstractmethod
    def run_application(self, *args, **kwargs):
        """Run the application's main loop: collect observations, take
        actions, assign rewards."""

    @abc.abstractmethod
    def build_observation(self, raw, *args, **kwargs):
        """Map the application's raw state to the policy observation.

        May return either ``obs`` or ``(obs, mask)`` — ``drive_episode``
        accepts both; a ``(obs, mask)`` tuple routes the mask into
        ``request_for_action`` for masked-action policies.
        """

    @abc.abstractmethod
    def calculate_performance_return(self, *args, **kwargs):
        """Reward for the episode's terminal transition — the value the
        loop passes to ``flag_last_action``. :meth:`drive_episode` calls
        it as ``calculate_performance_return(last_reward, terminated=...,
        truncated=...)``; the identity implementation ``return
        last_reward`` reproduces the canonical unshaped loop."""

    def drive_episode(self, env, max_steps: int | None = None) -> float:
        """One episode of the canonical actor loop; returns the raw
        env-reward sum (terminal shaping from
        ``calculate_performance_return`` is what trains, but the raw sum
        is the comparable metric across shaping choices).

        Rewards ride the NEXT ``request_for_action`` so each record's
        ``rew`` means "reward earned by this action" (see
        policy_actor.py on the deliberate departure from the reference's
        one-step credit shift); the terminal reward goes through
        ``flag_last_action`` with ``terminated``/``truncated`` and the
        final observation forwarded, which off-policy learners need for
        correct bootstrapping at time limits.
        """
        raw = env.reset()
        pending_reward = 0.0
        total = 0.0
        steps = 0
        while True:
            built = self.build_observation(raw)
            obs, mask = built if isinstance(built, tuple) else (built, None)
            record = self.agent.request_for_action(
                obs, mask=mask, reward=pending_reward)
            raw, reward, terminated, truncated = env.step(
                coerce_env_action(record.act))
            pending_reward = float(reward)
            total += pending_reward
            steps += 1
            if max_steps is not None and steps >= max_steps:
                truncated = True
            if terminated or truncated:
                # Successor state only matters for bootstrapping through a
                # time limit; on a genuine terminal the target is zeroed,
                # and the canonical loops pass None (so applications whose
                # terminal raw state can't build an observation still work).
                if truncated and not terminated:
                    final_built = self.build_observation(raw)
                    final_obs, final_mask = (
                        final_built if isinstance(final_built, tuple)
                        else (final_built, None))
                else:
                    final_obs = final_mask = None
                self.agent.flag_last_action(
                    reward=float(self.calculate_performance_return(
                        pending_reward, terminated=terminated,
                        truncated=truncated)),
                    terminated=terminated,
                    truncated=truncated,
                    final_obs=final_obs,
                    final_mask=final_mask,
                )
                return total
