"""TokenGen as batched tensors: the device twin of ``envs/tokengen.py``,
and the counterpart of :mod:`relayrl_tpu.envs.jax.tokengen`.

All-integer dynamics (prompt sampling, token buffer writes, flags), so
observation, flags and counters equal the numpy and JAX twins' bit for
bit. The reward is paid at the terminal step by the scorer's batched
``score_torch(tokens [N, L], prompt_len, gen_len [N]) -> [N]``, which
runs inside the fused window (a host-only ``score_np`` scorer serves the
numpy twin).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from relayrl_tpu_torch.envs.device.base import DeviceEnv
from relayrl_tpu_torch.envs.spaces import Box, Discrete
from relayrl_tpu_torch.envs.tokengen import EOS_TOKEN, _resolve_scorer
from relayrl_tpu_torch.models.base import resolve_device


class TokenGenState(NamedTuple):
    tokens: torch.Tensor  # [N, prompt_len + max_new_tokens] int32
    t: torch.Tensor       # [N] int32 generated-token count


class DeviceTokenGen(DeviceEnv):
    """One generation per episode: obs = int32 token context window,
    action = next token, terminal at EOS or ``max_new_tokens`` (both
    ``terminated``: the scorer pays the whole return at the boundary)."""

    def __init__(self, vocab_size: int = 8, prompt_len: int = 3,
                 max_new_tokens: int = 8, scorer=None, device=None):
        if vocab_size < 2:
            raise ValueError("vocab_size must be >= 2 (EOS + 1 real token)")
        if prompt_len < 1 or max_new_tokens < 1:
            raise ValueError("prompt_len and max_new_tokens must be >= 1")
        self.vocab_size = int(vocab_size)
        self.prompt_len = int(prompt_len)
        self.max_new_tokens = int(max_new_tokens)
        self.context_len = self.prompt_len + self.max_new_tokens
        self.device = resolve_device(device)
        self.scorer = _resolve_scorer(scorer, self.device)
        if (self.scorer is not None
                and not callable(getattr(self.scorer, "score_torch", None))):
            raise ValueError(
                "the on-device TokenGen needs a batched tensor scorer "
                "(score_torch); host-only callables serve the numpy twin")
        self.observation_space = Box(0, self.vocab_size - 1,
                                     shape=(self.context_len,),
                                     dtype=np.int32)
        self.action_space = Discrete(self.vocab_size)

    def reset(self, generator, n):
        prompt = torch.randint(1, self.vocab_size, (n, self.prompt_len),
                               generator=generator, device=self.device,
                               dtype=torch.int32)
        tokens = torch.cat([prompt, torch.zeros((n, self.max_new_tokens),
                                                dtype=torch.int32, device=self.device)],
                           dim=1)
        state = TokenGenState(tokens=tokens,
                              t=torch.zeros(n, dtype=torch.int32, device=self.device))
        return state, tokens

    def step(self, state, action, generator=None):
        token = torch.clamp(action.reshape(-1).to(torch.int32), 0, self.vocab_size - 1)
        at = (torch.arange(self.context_len, device=self.device)[None]
              == (self.prompt_len + state.t)[:, None])
        tokens = torch.where(at, token[:, None], state.tokens)
        t = state.t + 1
        terminated = (token == EOS_TOKEN) | (t >= self.max_new_tokens)
        if self.scorer is not None:
            score = self.scorer.score_torch(tokens, self.prompt_len, t).to(torch.float32)
            reward = torch.where(terminated, score, 0.0)
        else:
            reward = torch.zeros(t.shape, dtype=torch.float32, device=self.device)
        return (TokenGenState(tokens=tokens, t=t), tokens, reward, terminated,
                torch.zeros_like(terminated))
