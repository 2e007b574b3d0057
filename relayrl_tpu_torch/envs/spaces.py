"""Minimal space descriptors (API-compatible subset of gymnasium.spaces)."""

from __future__ import annotations

import numpy as np


class Discrete:
    def __init__(self, n: int):
        self.n = int(n)
        self.shape = ()
        self.dtype = np.int64

    def sample(self, rng: np.random.Generator | None = None) -> int:
        rng = rng or np.random.default_rng()
        return int(rng.integers(self.n))

    def contains(self, x) -> bool:
        return 0 <= int(x) < self.n

    def __repr__(self):
        return f"Discrete({self.n})"


class Box:
    def __init__(self, low, high, shape=None, dtype=np.float32):
        if shape is None:
            shape = np.broadcast(np.asarray(low), np.asarray(high)).shape
        self.shape = tuple(shape)
        self.low = np.broadcast_to(np.asarray(low, dtype), self.shape)
        self.high = np.broadcast_to(np.asarray(high, dtype), self.shape)
        self.dtype = dtype

    def sample(self, rng: np.random.Generator | None = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        low = np.clip(self.low, -1e6, 1e6)
        high = np.clip(self.high, -1e6, 1e6)
        return rng.uniform(low, high).astype(self.dtype)

    def contains(self, x) -> bool:
        arr = np.asarray(x)
        return arr.shape == self.shape and bool(
            np.all(arr >= self.low) and np.all(arr <= self.high)
        )

    def __repr__(self):
        return f"Box{self.shape}"
