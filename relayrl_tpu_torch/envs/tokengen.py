"""TokenGen: token-level autoregressive generation env (numpy built-in).

A copy of :mod:`relayrl_tpu.envs.tokengen`; seeded alike, it gives the
same bits. The RLHF workload plane's environment: one episode is one
generation. The agent sees the current **token context window** — an
int32 buffer of length ``prompt_len + max_new_tokens`` holding the
sampled prompt followed by the tokens generated so far (zero-padded
ahead of the write position; token 0 is reserved as EOS/pad) — and emits
the next token as its action. The episode ends when the agent emits EOS
or fills ``max_new_tokens``; at that boundary a pluggable **scorer**
pays the whole sequence's reward in one terminal step (per-step reward
is always 0.0 — the RLHF shape: credit arrives only at the end of the
generation).

``scorer=None`` is the *decoupled-dataflow* mode: terminal reward stays
0.0 and a downstream score stage assigns it before the episode reaches
the learner (the JAX package's ``rlhf/scheduler.py``, not ported yet:
ROADMAP queue 1 item 15). With a scorer attached the env is
self-contained (CI loops, the anakin tier via the batched device twin).

Both endings are ``terminated`` (never ``truncated``): reaching
``max_new_tokens`` is part of the MDP — the scorer pays the full return
at that boundary and there is no post-boundary state to bootstrap
through, unlike a time-limit cut of an ongoing task.

Dynamics are all-integer (prompt sampling, buffer writes, flags), so
the batched device twin (``envs/device/tokengen.py``) holds FULL bitwise
parity on observation/flags/counters; the reward is bit-equal too
whenever the scorer's ``score_np`` and ``score_torch`` agree.
"""

from __future__ import annotations

import numpy as np

from relayrl_tpu_torch.envs.spaces import Box, Discrete

EOS_TOKEN = 0


def _resolve_scorer(scorer):
    """Accept a scorer object (``score_np(tokens, prompt_len, gen_len)``
    and/or the batched device twin ``score_torch(tokens [N, L],
    prompt_len, gen_len [N]) -> [N]``), a plain host callable with the
    ``score_np`` signature, or None (decoupled mode — reward assigned
    downstream by the score stage). Named scorers live in the RLHF plane,
    which the port does not have yet (ROADMAP queue 1 item 15)."""
    if scorer is None:
        return None
    if isinstance(scorer, str):
        raise ValueError(
            f"named scorer {scorer!r}: the registered scorers belong to the "
            "RLHF plane, not ported (ROADMAP queue 1 item 15); pass a scorer "
            "object or a callable")
    if (callable(getattr(scorer, "score_np", None))
            or callable(getattr(scorer, "score_torch", None))):
        return scorer
    if callable(scorer):
        class _Wrapped:
            score_np = staticmethod(scorer)
        return _Wrapped()
    raise ValueError(f"scorer must be None, a callable, or expose "
                     f"score_np/score_torch; got {type(scorer).__name__}")


class TokenGenEnv:
    """One generation per episode: obs = int32 token context window,
    action = next token, terminal at EOS/max_new_tokens, scored at the
    boundary."""

    def __init__(self, vocab_size: int = 8, prompt_len: int = 3,
                 max_new_tokens: int = 8, scorer=None):
        if vocab_size < 2:
            raise ValueError("vocab_size must be >= 2 (EOS + 1 real token)")
        if prompt_len < 1 or max_new_tokens < 1:
            raise ValueError("prompt_len and max_new_tokens must be >= 1")
        self.vocab_size = int(vocab_size)
        self.prompt_len = int(prompt_len)
        self.max_new_tokens = int(max_new_tokens)
        self.context_len = self.prompt_len + self.max_new_tokens
        self.scorer = _resolve_scorer(scorer)
        self.observation_space = Box(0, self.vocab_size - 1,
                                     shape=(self.context_len,),
                                     dtype=np.int32)
        self.action_space = Discrete(self.vocab_size)
        self._rng = np.random.default_rng()
        self._tokens = np.zeros(self.context_len, np.int32)
        self._t = 0

    def reset(self, seed: int | None = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._tokens = np.zeros(self.context_len, np.int32)
        # Prompts draw from the REAL vocabulary [1, V): an EOS inside the
        # prompt would alias the pad region and make gen_len ambiguous.
        self._tokens[: self.prompt_len] = self._rng.integers(
            1, self.vocab_size, self.prompt_len, dtype=np.int32)
        self._t = 0
        return self._tokens.copy(), {}

    def step(self, action):
        token = int(np.clip(int(action), 0, self.vocab_size - 1))
        self._tokens[self.prompt_len + self._t] = token
        self._t += 1
        terminated = (token == EOS_TOKEN) or (self._t >= self.max_new_tokens)
        reward = 0.0
        if terminated and self.scorer is not None:
            reward = float(self.scorer.score_np(
                self._tokens, self.prompt_len, self._t))
        return self._tokens.copy(), reward, terminated, False, {}
