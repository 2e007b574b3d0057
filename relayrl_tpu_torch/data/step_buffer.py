"""Uniform step replay buffer (the off-policy ingest path).

A copy of :mod:`relayrl_tpu.data.step_buffer`, its imports rewritten to
the port's ``ActionRecord``, ``fold_trailing_markers`` and
``DecodedTrajectory``. A fixed-capacity ring of transitions in host numpy
arrays, sampling fixed-size batches. Seeded alike, its sample indices
equal the JAX package's ring's bit for bit (the same numpy generator
draws them), so both packages train on the same batches.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from relayrl_tpu_torch.types.action import ActionRecord


class StepReplayBuffer:
    """Ring buffer of ``(obs, act, rew, obs2, done)`` transitions.

    ``add_episode`` unrolls an ActionRecord trajectory: record ``t`` holds
    ``(obs_t, act_t, rew_t)`` (terminal markers already folded by the caller
    or carrying their reward here), ``obs2`` comes from record ``t+1``. A
    time-limit truncation whose marker carries the post-step observation is
    stored with ``done=0`` and that observation as the bootstrap successor;
    a truncated final step without one is dropped — its bootstrap target is
    unknowable without ``obs_{T+1}``.
    """

    def __init__(self, obs_dim: int, act_dim: int, capacity: int,
                 discrete: bool = True, seed: int = 0,
                 obs_dtype=np.float32):
        self.obs_dim, self.act_dim = int(obs_dim), int(act_dim)
        self.capacity = int(capacity)
        self.discrete = bool(discrete)
        # uint8 rings (pixel replay): 4x less host memory, 4x smaller
        # checkpoint aux snapshots, and 4x less host->device transfer
        # per sampled batch — samples keep the stored dtype and the CNN
        # q-trunk casts + scales /255 on-device (models/cnn.py). Float
        # observations written into a uint8 ring would truncate; pair
        # this with the env pipeline's obs_dtype="uint8".
        self.obs_dtype = np.dtype(obs_dtype)
        if self.obs_dtype not in (np.dtype(np.float32), np.dtype(np.uint8)):
            raise ValueError(f"obs_dtype must be float32|uint8, "
                             f"got {self.obs_dtype}")
        self.obs = np.zeros((capacity, obs_dim), self.obs_dtype)
        self.obs2 = np.zeros((capacity, obs_dim), self.obs_dtype)
        if discrete:
            self.act = np.zeros((capacity,), np.int32)
        else:
            self.act = np.zeros((capacity, act_dim), np.float32)
        self.mask2 = np.ones((capacity, act_dim), np.float32)
        self.rew = np.zeros((capacity,), np.float32)
        self.done = np.zeros((capacity,), np.float32)
        self.ptr = 0
        self.size = 0
        self.total_steps = 0
        self._seed = int(seed)
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self.size

    def _check_obs_dtype(self, incoming) -> None:
        """Fail fast on the documented footgun: float observations into a
        uint8 ring would silently floor to all-zero (the learner-side
        obs_dtype knob must be PAIRED with the env pipeline's)."""
        if (self.obs_dtype == np.uint8
                and np.issubdtype(np.dtype(incoming), np.floating)):
            raise ValueError(
                "float observations fed to a uint8 replay ring — set the "
                "env pipeline's obs_dtype=\"uint8\" too (envs/atari.py), "
                "or drop the algorithm's obs_dtype knob")

    def _put(self, obs, act, rew, obs2, done, mask2):
        i = self.ptr
        self.obs[i] = obs
        self.obs2[i] = obs2
        if self.discrete:
            self.act[i] = int(np.asarray(act).reshape(-1)[0])
        else:
            self.act[i] = np.asarray(act, np.float32).reshape(-1)[: self.act_dim]
        self.mask2[i] = mask2
        self.rew[i] = float(rew)
        self.done[i] = float(done)
        self.ptr = (i + 1) % self.capacity
        self.size = min(self.size + 1, self.capacity)
        self.total_steps += 1

    def _put_many(self, obs, act, rew, obs2, done, mask2) -> int:
        """Vectorized ring insert (columnar fast path)."""
        k = len(rew)
        if k == 0:
            return 0
        idx = (self.ptr + np.arange(k)) % self.capacity
        self.obs[idx] = obs
        self.obs2[idx] = obs2
        if self.discrete:
            self.act[idx] = act.reshape(k, -1)[:, 0]
        else:
            self.act[idx] = act.reshape(k, -1)[:, : self.act_dim]
        self.mask2[idx] = mask2
        self.rew[idx] = rew
        self.done[idx] = done
        self.ptr = int((self.ptr + k) % self.capacity)
        self.size = int(min(self.size + k, self.capacity))
        self.total_steps += k
        return k

    def add_decoded(self, dt) -> int:
        """Columnar fast path of :meth:`add_episode` for a
        :class:`relayrl_tpu_torch.types.columnar.DecodedTrajectory` (markers
        already folded by the native decoder). Same transition semantics
        as the ActionRecord loop below; parity enforced by
        tests/test_torch_offpolicy.py."""
        cols = dt.columns
        T = dt.n_steps
        if T == 0 or "o" not in cols or "a" not in cols:
            return 0
        self._check_obs_dtype(cols["o"].dtype)
        obs = cols["o"].reshape(T, -1)[:, : self.obs_dim].astype(
            self.obs_dtype, copy=False)
        act = cols["a"]
        rew = cols["r"].astype(np.float32, copy=False)
        done_last = bool(cols["t"][T - 1])
        trunc_last = dt.marker_truncated or bool(cols["x"][T - 1])

        obs2 = np.zeros((T, self.obs_dim), self.obs_dtype)
        if T > 1:
            obs2[: T - 1] = obs[1:]
        mask2 = np.ones((T, self.act_dim), np.float32)
        if "m" in cols:
            m = cols["m"].reshape(T, -1)[:, : self.act_dim].astype(
                np.float32, copy=False)
            if T > 1:
                mask2[: T - 1] = m[1:]
        done = np.zeros((T,), np.float32)

        n = T
        if trunc_last or not done_last:
            # Time-limit ending: bootstrap through the boundary (done=0)
            # using the marker's successor obs — or drop the last
            # transition when no successor was shipped.
            if dt.final_obs is None:
                n = T - 1
            else:
                obs2[T - 1] = np.asarray(
                    dt.final_obs, self.obs_dtype).reshape(-1)[: self.obs_dim]
                if dt.final_mask is not None:
                    mask2[T - 1] = np.asarray(
                        dt.final_mask, np.float32).reshape(-1)[: self.act_dim]
        else:
            done[T - 1] = 1.0
        return self._put_many(obs[:n], act[:n], rew[:n], obs2[:n], done[:n],
                              mask2[:n])

    def add_episode(self, actions: Sequence[ActionRecord]) -> int:
        """Unroll one trajectory into transitions; returns how many stored."""
        from relayrl_tpu_torch.data.batching import fold_trailing_markers
        from relayrl_tpu_torch.types.columnar import DecodedTrajectory

        if isinstance(actions, DecodedTrajectory):
            return self.add_decoded(actions)

        # A truncation marker may carry the post-step observation — the
        # bootstrap successor for the final transition — and its action
        # mask, so masked bootstrap targets stay legal.
        steps, final_obs, truncated, final_mask = fold_trailing_markers(actions)
        for rec in steps:  # one dtype check per episode (uint8 footgun)
            if rec.obs is not None:
                self._check_obs_dtype(np.asarray(rec.obs).dtype)
                break
        stored = 0
        ones = np.ones((self.act_dim,), np.float32)
        for t, rec in enumerate(steps):
            if rec.obs is None or rec.act is None:
                continue
            is_last = t == len(steps) - 1
            if is_last:
                if truncated or rec.truncated or not rec.done:
                    # Time-limit ending: the value target must bootstrap
                    # through the boundary (done=0). That needs a real
                    # successor obs — without one the transition is
                    # unknowable and dropped.
                    if final_obs is None:
                        break
                    obs2 = final_obs.reshape(-1)[: self.obs_dim]
                    mask2 = (ones if final_mask is None
                             else np.asarray(final_mask, np.float32)
                             .reshape(-1)[: self.act_dim])
                    done = 0.0
                else:
                    obs2 = np.zeros((self.obs_dim,), self.obs_dtype)
                    mask2 = ones
                    done = 1.0
            else:
                nxt = steps[t + 1]
                if nxt.obs is None:
                    continue
                obs2 = np.asarray(nxt.obs, self.obs_dtype).reshape(-1)[: self.obs_dim]
                mask2 = (np.asarray(nxt.mask, np.float32).reshape(-1)[: self.act_dim]
                         if nxt.mask is not None else ones)
                done = 0.0
            obs = np.asarray(rec.obs, self.obs_dtype).reshape(-1)[: self.obs_dim]
            self._put(obs, rec.act, rec.rew, obs2, done, mask2)
            stored += 1
        return stored

    def scrub_nonfinite(self) -> int:
        """Drop every stored transition carrying a non-finite value in
        any float field, compacting the survivors to the front of the
        ring in chronological order. Returns how many were dropped.

        Normally the ring is finite by construction (the off-policy
        ingest belt rejects non-finite trajectories before ``add_*``);
        under guardrails' ``ingest_validation: "warn"`` posture that
        belt stands down, and a post-rollback ring may hold admitted
        poison that would re-diverge every update after the restore —
        this is the rollback path's decontamination pass."""
        s = self.size
        if s == 0:
            return 0
        if s == self.capacity and self.ptr:
            order = np.r_[self.ptr:s, 0:self.ptr]
        else:
            order = np.arange(s)
        keep = np.isfinite(self.rew[order]) & np.isfinite(self.done[order])
        keep &= np.isfinite(self.mask2[order]).all(axis=1)
        if self.obs_dtype != np.uint8:  # uint8 cannot hold NaN/Inf
            keep &= np.isfinite(self.obs[order]).all(axis=1)
            keep &= np.isfinite(self.obs2[order]).all(axis=1)
        if not self.discrete:
            keep &= np.isfinite(self.act[order]).all(axis=1)
        dropped = int(s - keep.sum())
        if dropped == 0:
            return 0
        kept = order[keep]
        for name in ("obs", "obs2", "act", "mask2", "rew", "done"):
            arr = getattr(self, name)
            arr[: len(kept)] = arr[kept]
        self.size = len(kept)
        self.ptr = self.size % self.capacity
        return dropped

    def state_arrays(self) -> dict[str, np.ndarray]:
        """Stored transitions in CHRONOLOGICAL order plus counters — the
        checkpoint payload (SURVEY §5.4: the reference loses its buffer on
        every restart; here off-policy resume keeps it). Only the filled
        region is saved; when the ring has wrapped, rolling by ``ptr``
        makes index 0 the oldest transition, so a restored buffer
        overwrites oldest-first exactly like the original would have."""
        s = self.size
        if s == self.capacity and self.ptr:
            order = np.r_[self.ptr:s, 0:self.ptr]
        else:
            order = np.arange(s)
        return {
            "obs": self.obs[order], "obs2": self.obs2[order],
            "act": self.act[order], "mask2": self.mask2[order],
            "rew": self.rew[order], "done": self.done[order],
            # 0-d ndarrays, as the JAX package saves them; they restore
            # through int() identically.
            "size": np.asarray(s, np.int64),
            "total_steps": np.asarray(self.total_steps, np.int64),
        }

    def load_state_arrays(self, d) -> None:
        """Inverse of :meth:`state_arrays`, tolerant of a capacity change:
        a buffer smaller than the checkpoint keeps the most recent
        transitions. The numpy sample RNG is reseeded deterministically
        from (seed, total_steps) rather than checkpointed — the update
        noise's generator state (inside the train state) restores exactly;
        the host-side sampler only needs independence, not replay."""
        n = int(d["size"])
        keep = min(n, self.capacity)
        sl = slice(n - keep, n)  # most recent when shrinking
        saved_obs_dt = np.asarray(d["obs"]).dtype
        if saved_obs_dt != self.obs_dtype:
            # A silent cast would corrupt the restored experience
            # (float [0,1] floors to all-zero bytes; bytes into a float
            # ring are 255x the live obs scale). Flip the ring dtype to
            # match the checkpoint, or start fresh.
            raise ValueError(
                f"checkpointed replay obs dtype {saved_obs_dt} != ring "
                f"obs_dtype {self.obs_dtype}; resume with a matching "
                f"obs_dtype (values are NOT rescalable across the flip)")
        for name in ("obs", "obs2", "act", "mask2", "rew", "done"):
            getattr(self, name)[:keep] = np.asarray(d[name])[sl]
        self.size = keep
        self.ptr = keep % self.capacity
        self.total_steps = int(d["total_steps"])
        self._rng = np.random.default_rng(
            (self._seed, self.total_steps))

    _SAMPLE_FIELDS = ("obs", "act", "rew", "obs2", "mask2", "done")

    def make_sample_out(self, batch_size: int) -> dict[str, np.ndarray]:
        """Allocate one reusable staging dict for :meth:`sample`'s
        ``out=`` — shaped/dtyped exactly like a fresh sample."""
        b = int(batch_size)
        return {name: np.empty((b,) + getattr(self, name).shape[1:],
                               getattr(self, name).dtype)
                for name in self._SAMPLE_FIELDS}

    def sample(self, batch_size: int,
               out: dict[str, np.ndarray] | None = None
               ) -> dict[str, np.ndarray]:
        """Uniform sample of a fixed-size batch (with replacement).

        ``out`` (from :meth:`make_sample_out`) gathers in place instead
        of allocating six fresh arrays per draw — the returned dict IS
        ``out``, valid until the caller reuses the buffers (the
        off-policy sample ring sizes itself so reuse trails the
        in-flight update window)."""
        if self.size == 0:
            raise ValueError("sample() on empty buffer")
        idx = self._rng.integers(0, self.size, size=int(batch_size))
        if out is None:
            return {name: getattr(self, name)[idx]
                    for name in self._SAMPLE_FIELDS}
        for name in self._SAMPLE_FIELDS:
            np.take(getattr(self, name), idx, axis=0, out=out[name])
        return out
