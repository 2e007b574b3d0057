"""Atari-style pixel pipeline: preprocessing wrapper + synthetic pixel env.

The reference has no pixel path at all (its envs are the Gymnasium
classic-control notebooks — reference: examples/README.md:125-152); the
north-star configs (BASELINE.md: "PPO Atari Pong (CNN)",
"IMPALA-style ... Breakout ×256 actors") need the standard DQN-lineage
preprocessing in front of the ``cnn_discrete``/IMPALA families:

* frame-skip with max-pool over the last two raw frames (flicker removal)
* grayscale + bilinear resize to ``frame_size``² (84×84 default)
* frame-stack of the last ``frame_stack`` processed frames (NHWC channels)
* uint8 [0,255] → float32 [0,1] happens at the wire boundary so replay
  stays byte-sized

Copy of :mod:`relayrl_tpu.envs.atari` (numpy only), with one change: the
port has no Gymnasium branch, so `make_atari` with a real ALE id raises
:class:`ALEUnavailableError`. `SyntheticPixelEnv` — a paddle/ball toy with
real reward structure rendered to raw RGB frames — carries the identical
pipeline end to end. `_resize_bilinear` keeps both of the reference's
branches: cv2 when it imports, else numpy on the same sampling grid; the
two round differently, so frames depend on which one the host has.
"""

from __future__ import annotations

import numpy as np

from relayrl_tpu_torch.envs.spaces import Box, Discrete


class ALEUnavailableError(RuntimeError):
    """A real ALE id asked of :func:`make_atari`, which builds only the
    synthetic toy."""


def _to_grayscale(frame: np.ndarray) -> np.ndarray:
    """RGB uint8 (H, W, 3) → luma uint8 (H, W) (ITU-R 601, the ALE/cv2
    weighting)."""
    if frame.ndim == 2:
        return frame
    return (frame @ np.array([0.299, 0.587, 0.114], np.float32)).astype(np.uint8)


def _resize_bilinear(img: np.ndarray, size: int) -> np.ndarray:
    """uint8 (H, W) → (size, size) bilinear. cv2 when available (what the
    DQN lineage uses), numpy fallback with the same sampling grid."""
    try:
        import cv2

        return cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)
    except ImportError:
        h, w = img.shape
        ys = np.linspace(0, h - 1, size)
        xs = np.linspace(0, w - 1, size)
        y0 = np.floor(ys).astype(int)
        x0 = np.floor(xs).astype(int)
        y1 = np.minimum(y0 + 1, h - 1)
        x1 = np.minimum(x0 + 1, w - 1)
        wy = (ys - y0)[:, None]
        wx = (xs - x0)[None, :]
        f = img.astype(np.float32)
        top = f[y0][:, x0] * (1 - wx) + f[y0][:, x1] * wx
        bot = f[y1][:, x0] * (1 - wx) + f[y1][:, x1] * wx
        return (top * (1 - wy) + bot * wy).astype(np.uint8)


class AtariPreprocessing:
    """Standard DQN preprocessing around any raw-pixel env.

    The wrapped env's ``step`` must return an RGB (or grayscale) uint8
    frame as observation. Exposes flat float32 observations of shape
    ``frame_size * frame_size * frame_stack`` in [0, 1] — the wire layout
    the ``cnn_discrete`` family reshapes to NHWC (models/cnn.py keeps the
    transport rank-agnostic).
    """

    def __init__(self, env, frame_size: int = 84, frame_stack: int = 4,
                 frame_skip: int = 4, max_pool: bool = True,
                 obs_dtype: str = "float32"):
        if frame_skip < 1:
            raise ValueError("frame_skip must be >= 1")
        if obs_dtype not in ("float32", "uint8"):
            raise ValueError(f"obs_dtype must be float32|uint8, "
                             f"got {obs_dtype!r}")
        self.env = env
        self.frame_size = frame_size
        self.frame_stack = frame_stack
        self.frame_skip = frame_skip
        self.max_pool = max_pool
        # "uint8": ship raw [0,255] bytes — 4x smaller trajectories on
        # the wire (the 84x84x4 north-star step is 28 KB as bytes vs
        # 113 KB as float32); off-policy learners can extend the saving
        # to replay + checkpoints with the algorithm-side
        # obs_dtype="uint8" knob (StepReplayBuffer's byte ring — the
        # two must be paired; the ring rejects float obs). Pair with
        # the CNN trunk's
        # default scale_obs=True (/255 on-device, models/cnn.py:105) for
        # unit-range inputs. NOTE the legacy float32 mode ALREADY
        # pre-normalizes to [0,1]; under scale_obs=True the net then
        # sees [0, 1/255] — consistent train/serve (the committed pixel
        # goldens learned in that regime) but not unit-range; uint8 mode
        # is the clean path.
        self.obs_dtype = obs_dtype
        self._stack = np.zeros((frame_size, frame_size, frame_stack), np.uint8)
        n = getattr(env.action_space, "n", None)
        self.action_space = env.action_space if n is not None else Discrete(2)
        flat = frame_size * frame_size * frame_stack
        self.observation_space = (
            Box(low=0, high=255, shape=(flat,), dtype=np.uint8)
            if obs_dtype == "uint8"
            else Box(low=0.0, high=1.0, shape=(flat,), dtype=np.float32))

    @property
    def obs_shape(self) -> tuple[int, int, int]:
        """(H, W, C) for the model arch's ``obs_shape``."""
        return (self.frame_size, self.frame_size, self.frame_stack)

    def _process(self, frame: np.ndarray) -> np.ndarray:
        return _resize_bilinear(_to_grayscale(np.asarray(frame)),
                                self.frame_size)

    def _push(self, processed: np.ndarray) -> None:
        self._stack = np.concatenate(
            [self._stack[:, :, 1:], processed[:, :, None]], axis=2)

    def _obs(self) -> np.ndarray:
        if self.obs_dtype == "uint8":
            return self._stack.reshape(-1).copy()
        return (self._stack.astype(np.float32) / 255.0).reshape(-1)

    def reset(self, seed: int | None = None):
        frame, info = self.env.reset(seed=seed)
        processed = self._process(frame)
        # Fill the whole stack with the first frame (standard init).
        self._stack = np.repeat(processed[:, :, None], self.frame_stack, axis=2)
        return self._obs(), info

    def step(self, action):
        total_reward, terminated, truncated, info = 0.0, False, False, {}
        prev_frame = None
        frame = None
        for _ in range(self.frame_skip):
            prev_frame = frame
            frame, reward, terminated, truncated, info = self.env.step(action)
            total_reward += float(reward)
            if terminated or truncated:
                break
        raw = np.asarray(frame)
        if self.max_pool and prev_frame is not None:
            raw = np.maximum(raw, np.asarray(prev_frame))
        self._push(self._process(raw))
        return self._obs(), total_reward, terminated, truncated, info


class SyntheticPixelEnv:
    """Catch-style pixel toy: move a paddle to intercept a falling ball.

    Raw RGB uint8 frames (``raw_size``² × 3), 3 actions (left/stay/right),
    +1 for a catch, -1 for a miss, episode ends after ``balls`` drops.
    Reward depends on behavior (not random), so CNN learning tests can
    assert improvement; random policy averages ~paddle_width/raw_size per
    ball.
    """

    def __init__(self, raw_size: int = 64, balls: int = 4, seed: int = 0,
                 shaped: bool = False):
        self.raw_size = raw_size
        self.balls = balls
        self.shaped = shaped  # add potential-based distance shaping
        self._rng = np.random.default_rng(seed)
        self.action_space = Discrete(3)
        self.observation_space = Box(
            low=0, high=255, shape=(raw_size, raw_size, 3), dtype=np.uint8)
        # Sprites must survive grayscale + downsize to the model's frame:
        # ball is a bright block ~1/10th of the board, paddle a full-width
        # strip of rows with a brighter catch zone.
        self._ball_r = max(1, raw_size // 20)
        self._paddle_half = max(2, raw_size // 10)
        self._paddle = raw_size // 2
        self._ball_x = 0
        self._ball_y = 0
        self._caught = 0

    def _frame(self) -> np.ndarray:
        f = np.zeros((self.raw_size, self.raw_size, 3), np.uint8)
        r = self._ball_r
        y = min(self._ball_y, self.raw_size - 1)
        f[max(0, y - r):y + r + 1,
          max(0, self._ball_x - r):self._ball_x + r + 1] = (255, 255, 255)
        lo = max(0, self._paddle - self._paddle_half)
        hi = min(self.raw_size, self._paddle + self._paddle_half + 1)
        f[-3:, lo:hi] = (200, 200, 200)
        return f

    def _new_ball(self) -> None:
        self._ball_x = int(self._rng.integers(self.raw_size))
        self._ball_y = 0

    def reset(self, seed: int | None = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._paddle = self.raw_size // 2
        self._caught = 0
        self._new_ball()
        return self._frame(), {}

    def step(self, action):
        prev_dist = abs(self._ball_x - self._paddle)
        self._paddle = int(np.clip(self._paddle + (int(action) - 1) * 3,
                                   0, self.raw_size - 1))
        self._ball_y += 2
        reward = 0.0
        if self.shaped:
            # Potential-based shaping (closing distance pays): dense credit
            # for pixel-perception tests with tight wall-clock budgets.
            reward += (prev_dist - abs(self._ball_x - self._paddle)) / 10.0
        if self._ball_y >= self.raw_size - 1:
            reward += (1.0 if abs(self._ball_x - self._paddle)
                       <= self._paddle_half else -1.0)
            self._caught += 1
            self._new_ball()
        terminated = self._caught >= self.balls
        return self._frame(), reward, terminated, False, {}


def make_atari(env_id: str = "synthetic", frame_size: int = 84,
               frame_stack: int = 4, frame_skip: int = 4,
               obs_dtype: str = "float32",
               **env_kwargs) -> AtariPreprocessing:
    """Preprocessed pixel env over the in-repo toy (``"synthetic"``); any
    other id raises :class:`ALEUnavailableError`. ``obs_dtype="uint8"``
    ships byte-range frames (4x smaller wire/replay payloads; see
    AtariPreprocessing)."""
    if env_id != "synthetic":
        raise ALEUnavailableError(
            f"make_atari({env_id!r}): the port has no Gymnasium/ALE branch; "
            f"only \"synthetic\" (SyntheticPixelEnv) is built in")
    raw = SyntheticPixelEnv(**env_kwargs)
    return AtariPreprocessing(raw, frame_size=frame_size,
                              frame_stack=frame_stack, frame_skip=frame_skip,
                              obs_dtype=obs_dtype)
