"""Sequence scorers for the RLHF workload plane.

Counterpart of :mod:`relayrl_tpu.rlhf.scorers`. A scorer assigns the
whole-generation reward paid at the episode's terminal boundary
(``envs/tokengen.py``). Each built-in exposes three planes:

* ``score_np(tokens, prompt_len, gen_len) -> float`` — host side, what the
  numpy twin env calls;
* ``score_batch_np(tokens [B, L], prompt_len, gen_lens [B]) -> [B]`` — the
  decoupled score stage's batched dispatch (``rlhf/scheduler.py``);
* ``score_torch(tokens [N, L] int32, prompt_len, gen_len [N]) -> [N] f32``
  — the batched tensor form the device twin (``envs/device/tokengen.py``)
  calls inside the fused window. It replaces the JAX package's per-row
  ``score_jax`` under ``vmap``.

Both numpy planes of both built-ins go through ``score_torch``, so one
implementation serves every plane.

Built-ins:

* ``ProgrammaticScorer`` ("programmatic") — an all-integer successor-
  pattern count: +1 for every generated non-EOS token equal to
  ``(previous token + 1) % vocab``. Its three planes equal the JAX
  package's bit for bit.
* ``RewardModelScorer`` ("reward_model") — a frozen randomly-initialized
  ``transformer_discrete`` critic (``has_critic=True``, dense attention)
  over one-hot token sequences; the score is ``tanh(v)`` read at the last
  generated position. Its params are drawn from a ``torch.Generator``
  seeded with ``seed``, so two port instances with the same (shape, seed)
  score identically; the same seed does NOT give the JAX package's reward
  model (threefry and torch's init streams differ). ``params=`` loads a
  flax params tree instead, which is how the tests carry the JAX model
  across. Every dispatch runs at one fixed width of ``batch_rows`` rows
  (shorter inputs are padded, longer ones run in chunks), so a row scores
  the same bits alone, in a batch, or in the score stage, whatever width
  the matrix library would otherwise pick a kernel for.
"""

from __future__ import annotations

import numpy as np
import torch

EOS_TOKEN = 0


def _as_int_tensor(x, device=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int64) if not torch.is_tensor(x) else x,
                           device=device).long()


def _offset(prompt_len):
    """A tensor prompt length stays one; anything else becomes a Python
    int, so no host-to-device copy is made (the device twin may call a
    scorer inside a captured window)."""
    return prompt_len if torch.is_tensor(prompt_len) else int(prompt_len)


class ProgrammaticScorer:
    """Successor-pattern count: the reward-maximizing generation continues
    the prompt's token chain ``t -> (t + 1) % vocab`` for ``max_new_tokens``
    steps without emitting EOS. Integer arithmetic end to end, so every
    plane agrees bit for bit; ``score_torch`` runs on its inputs' device."""

    name = "programmatic"

    def __init__(self, vocab_size: int = 8):
        self.vocab_size = int(vocab_size)

    def score_torch(self, tokens, prompt_len, gen_len) -> torch.Tensor:
        tokens = torch.as_tensor(tokens).to(torch.int32)
        device = tokens.device
        gen_len = _as_int_tensor(gen_len, device).reshape(-1)
        prompt_len = _offset(prompt_len)
        idx = torch.arange(tokens.shape[1], device=device)
        in_gen = (idx[None] >= prompt_len) & (idx[None] < prompt_len + gen_len[:, None])
        prev = torch.cat([torch.zeros_like(tokens[:, :1]), tokens[:, :-1]], dim=1)
        correct = (tokens == (prev + 1) % self.vocab_size) & (tokens != EOS_TOKEN) & in_gen
        return correct.sum(dim=1).to(torch.float32)

    def score_np(self, tokens, prompt_len: int, gen_len: int) -> float:
        tokens = torch.from_numpy(np.asarray(tokens, np.int32).reshape(1, -1))
        return float(self.score_torch(tokens, int(prompt_len), [int(gen_len)])[0])

    def score_batch_np(self, tokens, prompt_len: int, gen_lens) -> np.ndarray:
        tokens = torch.from_numpy(np.ascontiguousarray(np.asarray(tokens, np.int32)))
        return self.score_torch(tokens, int(prompt_len), gen_lens).numpy()


class RewardModelScorer:
    """Frozen transformer reward model over one-hot token sequences.

    ``score = tanh(v[clip(prompt_len + gen_len - 1)])`` — the critic head's
    value at the last generated position, squashed so the reward scale stays
    bounded for the V-trace learner whatever the init. The params are made
    once (from ``seed``, or loaded from the flax tree ``params``) on
    ``device`` (default: the GPU; without one the caller must pass
    ``device="cpu"``) and never updated. Every forward runs ``batch_rows``
    rows (see the module docstring)."""

    name = "reward_model"

    def __init__(self, vocab_size: int = 8, context_len: int = 11,
                 d_model: int = 32, n_layers: int = 1, n_heads: int = 2,
                 seed: int = 7, device=None, params=None, batch_rows: int = 8):
        from relayrl_tpu_torch.models import build_policy

        self.vocab_size = int(vocab_size)
        self.context_len = int(context_len)
        self.batch_rows = max(1, int(batch_rows))
        self.arch = {
            "kind": "transformer_discrete",
            "obs_dim": self.vocab_size,
            "act_dim": self.vocab_size,
            "d_model": int(d_model),
            "n_layers": int(n_layers),
            "n_heads": int(n_heads),
            "max_seq_len": self.context_len,
            "has_critic": True,
        }
        self._policy = build_policy(self.arch, device)
        self.device = self._policy.device
        self.params = (self._policy.load_params(params) if params is not None
                       else self._policy.init_params(torch.Generator().manual_seed(int(seed))))
        self.params.requires_grad_(False)

    def _forward(self, tokens: torch.Tensor, read: torch.Tensor) -> torch.Tensor:
        """One forward of ``tokens [R, L]`` on the RM's device; the tanh of
        each row's value at ``read [R]``."""
        onehot = torch.nn.functional.one_hot(tokens, self.vocab_size).to(torch.float32)
        with torch.no_grad():
            _logp, _ent, v = self._policy.evaluate(self.params, onehot, tokens)
        return torch.tanh(v.gather(1, read[:, None])[:, 0])

    def score_torch(self, tokens, prompt_len, gen_len) -> torch.Tensor:
        tokens = torch.as_tensor(tokens)
        out_device = tokens.device
        tokens = tokens.to(self.device).long()
        n, length = tokens.shape
        gen_len = _as_int_tensor(gen_len, self.device).reshape(-1)
        read = (gen_len + _offset(prompt_len) - 1).clamp(0, length - 1)
        rows = self.batch_rows
        pad = -n % rows
        if pad:  # repeat the last row: inert, sliced off below
            tokens = torch.cat([tokens, tokens[-1:].expand(pad, length)])
            read = torch.cat([read, read[-1:].expand(pad)])
        scores = [self._forward(tokens[i:i + rows], read[i:i + rows])
                  for i in range(0, n + pad, rows)]
        return torch.cat(scores)[:n].to(out_device)

    def score_np(self, tokens, prompt_len: int, gen_len: int) -> float:
        tokens = torch.from_numpy(np.asarray(tokens, np.int32).reshape(1, -1))
        return float(self.score_torch(tokens, int(prompt_len), [int(gen_len)])[0])

    def score_batch_np(self, tokens, prompt_len: int, gen_lens) -> np.ndarray:
        tokens = torch.from_numpy(np.ascontiguousarray(np.asarray(tokens, np.int32)))
        return self.score_torch(tokens, int(prompt_len), gen_lens).cpu().numpy()


SCORERS = {
    ProgrammaticScorer.name: ProgrammaticScorer,
    RewardModelScorer.name: RewardModelScorer,
}


def make_scorer(name: str, device=None, **kwargs):
    """Scorer by registered name (the ``rlhf.scorer`` config knob).
    ``device`` places a scorer that holds weights (the reward model); the
    programmatic scorer runs on its inputs' device."""
    if name not in SCORERS:
        raise ValueError(
            f"unknown scorer {name!r}; registered: {sorted(SCORERS)}")
    if name == RewardModelScorer.name:
        kwargs["device"] = device
    return SCORERS[name](**kwargs)
