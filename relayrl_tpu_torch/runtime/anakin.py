"""Fused on-device rollout engine: the Anakin tier of the actor plane.

Counterpart of :mod:`relayrl_tpu.runtime.anakin`. With the env itself on
the device (:mod:`relayrl_tpu_torch.envs.device`, batched over lanes), a
whole ``[lanes, unroll]`` trajectory window is one program: ``unroll``
times a policy step (``step_window`` over each lane's rolling window for a
sequence policy) and :func:`~relayrl_tpu_torch.envs.device.step_autoreset`,
with every step written into preallocated ``[N, U, ...]`` device buffers
and the carry (env state, observations, windows) held in static device
tensors: a ring, not an allocator (the JAX package donates its carry).

On a CUDA device the host captures that window once as a
``torch.cuda.CUDAGraph`` (after an eager warm-up on a side stream) and
replays it per window: the port's form of the JAX package's one
``jax.jit(vmap(lax.scan(...)))`` dispatch. The policy's and the env's
``torch.Generator`` streams are registered with the graph, so every replay
draws fresh numbers; exploration knobs are device scalars updated in
place; a hot swap copies the new params into the tensors the graph reads,
under the host's lock, between windows. A capture that fails raises with
its cause. On the CPU the same function runs uncaptured (the eager
window), and ``chip_smoke.py`` holds the graph to it on the card. The
Python launch counters of the kernels the window runs (K1 in a sequence
policy's layers) count at capture, once; :attr:`AnakinActorHost.
captured_launches` times :attr:`~AnakinActorHost.replays` is what the
replays launched.

The host side is the JAX package's unstacker, unchanged: one copy of the
window into pinned host buffers (its ``device_get``; two buffers, so an
off-thread emitter never reads one the next window is copied into), then
a replay into the per-lane trajectory streams, per record or as columnar
frames, byte-equal to what a vector host would have put on the wire for
the same steps. With tracing on, the window's production stamp (taken on
the host before the replay, never inside the captured graph) and each
frame's encode bracket become the ``env`` and ``encode`` hops of an
emitted segment's trajectory trace.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from relayrl_tpu_torch.envs.device import DeviceEnv, make_device, step_autoreset
from relayrl_tpu_torch.models import build_policy, validate_policy
from relayrl_tpu_torch.models.base import resolve_device
from relayrl_tpu_torch.runtime.policy_actor import (
    apply_bundle_swap,
    apply_wire_swap,
    resolve_actor_context,
    window_advance,
)
from relayrl_tpu_torch.types.action import ActionRecord
from relayrl_tpu_torch.types.columnar import DecodedTrajectory, encode_columnar_frame
from relayrl_tpu_torch.types.model_bundle import ModelBundle, exploration_kwargs
from relayrl_tpu_torch.types.trajectory import Trajectory

# The env generator's seed folds this into the host seed, as the JAX host
# folds it into its env key: policy and env streams never alias.
ENV_SEED_FOLD = 0x0E74
WINDOW_KEYS = ("obs", "act", "rew", "term", "trunc", "final_obs")


def env_seed(seed: int) -> int:
    """The env generator's seed for host seed ``seed``."""
    return ((int(seed) % (1 << 47)) << 16) | ENV_SEED_FOLD


def resolve_device_env(env, device=None, **env_kwargs) -> DeviceEnv:
    """Env argument -> :class:`DeviceEnv` on ``device``: ids go through the
    on-device registry (``envs.device.DEVICE_ENVS``, which
    ``envs.list_envs()`` reports), instances pass through when they live
    on that device."""
    device = resolve_device(device)
    if isinstance(env, DeviceEnv):
        if env.device != device:
            raise ValueError(f"env lives on {env.device}, the host on {device}")
        return env
    return make_device(str(env), device=device, **env_kwargs)


def _launch_counts() -> tuple[int, ...]:
    """The port's kernel launch counters (K1-K3, K4-K6)."""
    from relayrl_tpu_torch.ops.flash import flash_attention
    from relayrl_tpu_torch.parallel import ring_flash as rf

    return (flash_attention.launches, flash_attention.dq_launches,
            flash_attention.dkv_launches, rf.chunk_fwd.launches,
            rf.chunk_dq.launches, rf.chunk_dkv.launches)


def make_fused_rollout(policy, env: DeviceEnv, unroll_length: int,
                       sequence: bool = False):
    """The window: ``fn(params, explore, pol_gen, env_gen, carry, window)``
    runs ``unroll_length`` env steps for every lane in place.

    ``carry`` holds ``"state"`` (the env's state tuple), ``"obs"`` and, for
    a sequence policy, ``"win"`` ``[N, W, obs_dim]`` float32 and ``"wlen"``
    ``[N]`` int32; it is read at the start and written back at the end.
    ``window`` receives ``[N, U, ...]`` tensors under ``WINDOW_KEYS`` and
    ``"aux"`` (a dict), created on the first call and written in place
    after. Wire dtypes are the JAX host's: the feed-forward body ships the
    env's observation raw; the sequence body ships uint8 as uint8 and
    everything else float32 (the vector tier normalizes before windowing);
    actions int32 (discrete) or float32; flags bool.

    The policy draws from ``pol_gen`` exactly as a vector host's batched
    step draws from its generator; the env draws every lane's reset at
    every step from ``env_gen``. A sequence lane's window is advanced by
    :func:`window_advance` before its ``step_window`` (which takes the
    post-push count of real rows) and emptied at its autoreset."""
    def fn(params, explore, pol_gen, env_gen, carry, window):
        state, obs = carry["state"], carry["obs"]
        win, wlen = carry.get("win"), carry.get("wlen")
        steps = {k: [] for k in WINDOW_KEYS}
        aux_steps: dict[str, list] = {}
        with torch.no_grad():
            for _ in range(unroll_length):
                if sequence:
                    wire_obs = obs if obs.dtype == torch.uint8 else obs.to(torch.float32)
                    win, wlen = window_advance(win, wlen, wire_obs)
                    act, aux = policy.step_window(params, pol_gen, win, wlen, None)
                else:
                    wire_obs = obs
                    act, aux = policy.step(params, pol_gen, obs, None, **explore)
                act = act.to(torch.float32 if act.is_floating_point() else torch.int32)
                state, next_obs, rew, term, trunc, final_obs = step_autoreset(
                    env, state, act, env_gen)
                if sequence:
                    done = term | trunc
                    win = torch.where(done[:, None, None], 0.0, win)
                    wlen = torch.where(done, 0, wlen)
                for key, value in zip(WINDOW_KEYS, (wire_obs, act, rew.to(torch.float32),
                                                    term, trunc, final_obs)):
                    steps[key].append(value)
                for key, value in aux.items():
                    aux_steps.setdefault(key, []).append(value.to(torch.float32))
                obs = next_obs
            outs = window.setdefault("aux", {})
            for key, values in aux_steps.items():
                if key in outs:
                    torch.stack(values, dim=1, out=outs[key])
                else:
                    outs[key] = torch.stack(values, dim=1)
            for key, values in steps.items():
                if key in window:
                    torch.stack(values, dim=1, out=window[key])
                else:
                    window[key] = torch.stack(values, dim=1)
            for dst, src in zip(carry["state"], state):
                dst.copy_(src)
            carry["obs"].copy_(obs)
            if sequence:
                carry["win"].copy_(win)
                carry["wlen"].copy_(wlen)
    return fn


class AnakinActorHost:
    """N on-device env lanes x ``unroll_length`` steps per fused window.

    Same logical-agent surface as :class:`~relayrl_tpu_torch.runtime.
    vector_actor.VectorActorHost` (N per-lane streams through ``on_send(lane,
    payload)``, one model gate for all lanes), but the action API is
    :meth:`rollout`: the env lives inside the window. ``device`` defaults
    to the GPU; without one the caller must pass ``device="cpu"``. ``seed``
    seeds the policy's generator (as a vector host's) and, folded, the
    env's. Sequence policies run fused over a per-lane rolling window of
    ``window_size`` rows (clamped to the model's serving context), and
    ``record_bver=True`` stamps each record's producing model version into
    the aux plane.
    """

    def __init__(
        self,
        bundle: ModelBundle,
        env,
        num_envs: int,
        unroll_length: int = 32,
        max_traj_length: int = 1000,
        on_send=None,
        seed: int = 0,
        validate: bool = True,
        columnar_wire: bool = True,
        async_emit: bool = False,
        emit_coalesce_frames: int = 1,
        window_size: int | None = None,
        record_bver: bool = False,
        device=None,
        **env_kwargs,
    ):
        if num_envs < 1:
            raise ValueError(f"num_envs must be >= 1, got {num_envs}")
        if unroll_length < 1:
            raise ValueError(f"unroll_length must be >= 1, got {unroll_length}")
        self._lock = threading.Lock()
        self.num_envs = int(num_envs)
        self.unroll_length = int(unroll_length)
        self.device = resolve_device(device)
        self.env = resolve_device_env(env, self.device, **env_kwargs)
        self.arch = dict(bundle.arch)
        obs_dim = int(self.arch["obs_dim"])
        if obs_dim != self.env.obs_dim:
            raise ValueError(
                f"model obs_dim {obs_dim} != env obs_dim {self.env.obs_dim} — the "
                f"fused rollout feeds the env's observation straight into the policy")
        self.policy = build_policy(self.arch, self.device)
        self._window_size: int | None = None
        if self.policy.step_window is not None:
            ctx = resolve_actor_context(self.arch)
            self._window_size = (ctx if window_size is None
                                 else max(1, min(int(window_size), ctx)))
        elif self.policy.step_cached is not None:
            raise ValueError(
                "KV-cache-only policies (step_cached without step_window) cannot run "
                "in the fused window — the cache's positions shift on every window "
                "roll, so the window recomputes from the rolling observations "
                "instead; use the single-lane PolicyActor for the cached path")
        self.params = self.policy.load_params(bundle.params)
        if validate:
            validate_policy(self.policy, self.params)
        # The module the window reads: swaps copy into it (see _install).
        self._live = self.params
        self.version = bundle.version
        self.swaps = 0
        self._explore_kwargs = exploration_kwargs(self.arch)
        self._explore = {k: torch.tensor(v, dtype=torch.float32, device=self.device)
                         for k, v in self._explore_kwargs.items()}
        self._wire_decoder = None  # one decoder, all lanes (see VectorActorHost)
        self.record_bver = bool(record_bver)
        self._rollout_fn = make_fused_rollout(
            self.policy, self.env, self.unroll_length,
            sequence=self._window_size is not None)

        self._pol_gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self._env_gen = torch.Generator(device=self.device).manual_seed(env_seed(seed))
        state, obs = self.env.reset(self._env_gen, self.num_envs)
        self._carry = {"state": state, "obs": obs}
        if self._window_size is not None:
            # Windows are always float32, as on the host tiers.
            self._carry["win"] = torch.zeros(
                (self.num_envs, self._window_size, self.env.obs_dim),
                dtype=torch.float32, device=self.device)
            self._carry["wlen"] = torch.zeros(self.num_envs, dtype=torch.int32,
                                              device=self.device)
        # The window's device buffers, made by its first run; the two
        # host buffers it is copied into, made at the first copy.
        self._window: dict = {}
        self._host_bufs: list[dict] | None = None
        self._next_buf = 0
        self.graph = None
        self.captured_launches = (0,) * 6  # K1-K6 launched by the capture
        self.replays = 0
        if self.device.type == "cuda":
            self._capture()

        self.columnar_wire = bool(columnar_wire)
        self.max_traj_length = int(max_traj_length)
        self._on_send = on_send
        # actor.emit_coalesce_frames: up to N completed columnar segments
        # of one lane in one batch-container send, flushed at window end.
        self.emit_coalesce = max(1, int(emit_coalesce_frames))
        self._coalesce_buf: list[list[bytes]] = [[] for _ in range(self.num_envs)]
        # Tracing stamps (telemetry/trace.py): the window production stamp
        # (rollout start, on the host) plus the last frame's encode
        # bracket, read by VectorAgent._emit_stamps when it mints a
        # trajectory trace context for an emitted columnar segment.
        self._window_born_ns = 0
        self._last_emit_stamps: tuple[int, int, int] | None = None
        self.trajectories = [
            Trajectory(
                max_length=max_traj_length,
                on_send=(None if on_send is None
                         else (lambda payload, _lane=lane: on_send(_lane, payload))))
            for lane in range(self.num_envs)
        ]
        # Per-lane columnar accumulators: column chunks pending until an
        # episode boundary or a max_traj_length flush.
        self._pending = [{"len": 0, "cols": {"o": [], "a": [], "r": []}, "aux": {}}
                         for _ in range(self.num_envs)]
        self._ep_ret = np.zeros(self.num_envs, np.float64)
        self.episode_returns: list[list[float]] = [[] for _ in range(self.num_envs)]

        # actor.async_emit: the unstack and sends run on an emitter thread,
        # overlapping the next window; the hand-off is bounded (depth 2).
        self.async_emit = bool(async_emit)
        self._emit_cond = threading.Condition()
        self._emit_queue: list[tuple[int, dict]] = []
        self._emit_pending = 0
        self._emit_error: Exception | None = None
        self._emit_stop = False
        self._emit_thread: threading.Thread | None = None
        self.start_emitter()

        from relayrl_tpu_torch import telemetry

        reg = telemetry.get_registry()
        self._m_steps = reg.counter(
            "relayrl_actor_env_steps_total",
            "policy steps served (one per env step per lane)")
        self._m_dispatches = reg.counter(
            "relayrl_actor_rollout_dispatches_total",
            "fused rollout dispatches (each serves lanes x unroll steps)")
        self._m_dispatch_s = reg.histogram(
            "relayrl_actor_rollout_dispatch_seconds",
            "fused rollout: device compute per [lanes, unroll] window")
        self._m_unstack_s = reg.histogram(
            "relayrl_actor_rollout_unstack_seconds",
            "fused rollout: host unstack of one window into trajectories")
        self._m_encode_s = reg.histogram(
            "relayrl_actor_rollout_encode_seconds",
            "fused rollout: columnar frame encode of one window")
        self._m_frames = reg.counter(
            "relayrl_actor_columnar_frames_total",
            "columnar trajectory frames encoded and handed to the wire")
        self._m_frame_bytes = reg.counter(
            "relayrl_actor_columnar_bytes_total",
            "columnar trajectory frame bytes encoded")
        self._m_sends = reg.counter(
            "relayrl_actor_emit_sends_total",
            "transport sends of encoded segments (emit_coalesce_frames "
            "folds several frames into one send)")
        reg.gauge("relayrl_actor_lanes",
                  "env lanes per batched dispatch on this host").set(self.num_envs)
        reg.gauge("relayrl_actor_unroll_length",
                  "env steps per lane per fused rollout dispatch").set(self.unroll_length)
        if self._window_size is not None:
            reg.gauge(
                "relayrl_actor_window_size",
                "rolling observation-window rows per lane in the fused "
                "sequence carry (0 rows = feed-forward policy)").set(self._window_size)

    # -- the window on the device --
    def _run(self, carry, window) -> None:
        self._rollout_fn(self._live, self._explore, self._pol_gen, self._env_gen,
                         carry, window)

    def snapshot(self) -> tuple:
        """The carry and both generators' states, for :meth:`restore`."""
        carry = {k: (type(v)(*(t.clone() for t in v)) if k == "state" else v.clone())
                 for k, v in self._carry.items()}
        return carry, self._pol_gen.get_state(), self._env_gen.get_state()

    def restore(self, snap: tuple) -> None:
        """Put the carry and the generators back to a :meth:`snapshot`, in
        place (the graph reads these tensors)."""
        carry, pol, env = snap
        for key, value in carry.items():
            if key == "state":
                for dst, src in zip(self._carry["state"], value):
                    dst.copy_(src)
            else:
                self._carry[key].copy_(value)
        self._pol_gen.set_state(pol)
        self._env_gen.set_state(env)

    def _capture(self) -> None:
        """One eager window on a side stream (loads the kernel libraries,
        launches each kernel once and allocates the window's buffers), the
        carry and generators put back, then the window captured as one
        CUDA graph with both generators registered. Raises with the cause
        when the capture fails; nothing falls back to the eager window."""
        if self.arch.get("attention") in ("flash", "ring"):
            from relayrl_tpu_torch import _kernels

            _kernels.build()
            for name in _kernels.KERNELS:
                _kernels.load(name)
        snap = self.snapshot()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._run(self._carry, self._window)
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.restore(snap)
        graph = torch.cuda.CUDAGraph()
        register = getattr(graph, "register_generator_state", None)
        if register is None:
            raise RuntimeError(
                "this torch has no CUDAGraph.register_generator_state: a graph "
                "capture of the window would repeat its random draws on every replay")
        register(self._pol_gen)
        register(self._env_gen)
        before = _launch_counts()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._run(self._carry, self._window)
        except Exception as exc:
            raise RuntimeError(f"capturing the anakin window as a CUDA graph failed: "
                               f"{exc!r}") from exc
        self.captured_launches = tuple(b - a for a, b in zip(before, _launch_counts()))
        self.graph = graph

    def produce(self, eager: bool = False) -> None:
        """Compute one window into the device buffers: replay the graph (on
        a CUDA device), or run the window eagerly (the CPU, or
        ``eager=True``: the same function uncaptured, for comparisons)."""
        if self.graph is not None and not eager:
            self.graph.replay()
            self.replays += 1
        else:
            self._run(self._carry, self._window)

    def _pinned_like(self, window: dict) -> dict:
        pin = self.device.type == "cuda"

        def like(t):
            return torch.empty(t.shape, dtype=t.dtype, device="cpu", pin_memory=pin)
        out = {k: like(window[k]) for k in WINDOW_KEYS}
        out["aux"] = {k: like(v) for k, v in window["aux"].items()}
        return out

    def window_to_host(self) -> dict:
        """One copy of the device window into the next of the two pinned
        host buffers, as numpy views (the JAX host's ``device_get``)."""
        if self._host_bufs is None:
            self._host_bufs = [self._pinned_like(self._window) for _ in range(2)]
        buf = self._host_bufs[self._next_buf]
        self._next_buf ^= 1
        for key in WINDOW_KEYS:
            buf[key].copy_(self._window[key], non_blocking=True)
        for key, value in self._window["aux"].items():
            buf["aux"][key].copy_(value, non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        out = {k: buf[k].numpy() for k in WINDOW_KEYS}
        out["aux"] = {k: v.numpy() for k, v in buf["aux"].items()}
        return out

    def _install(self) -> None:
        """Under the lock, between windows: a swapped-in params module is
        copied into the tensors the window reads (a captured graph holds
        their addresses), and changed exploration knobs into their device
        scalars."""
        if self.params is not self._live:
            live = self._live.state_dict()
            with torch.no_grad():
                for key, value in self.params.state_dict().items():
                    live[key].copy_(value)
            self.params = self._live
        if self._explore_kwargs.keys() != self._explore.keys():
            raise ValueError(f"exploration knobs changed from {sorted(self._explore)} to "
                             f"{sorted(self._explore_kwargs)}; the window was built for "
                             f"the first set")
        for key, value in self._explore_kwargs.items():
            self._explore[key].fill_(value)

    # -- fused action API --
    def rollout(self) -> dict:
        """ONE window of ``lanes x unroll`` env steps on the device, then
        the host unstack into the per-lane trajectory streams. Returns
        ``{"steps", "episodes", "dispatch_s", "unstack_s", ...}``;
        completed episode returns accumulate on :attr:`episode_returns`."""
        t0 = time.monotonic()
        born_ns = time.monotonic_ns()
        with self._lock:
            # One params read under the lock for the whole window: every
            # step of it is computed by a single model version.
            self._install()
            version = self.version
            self.produce()
        if self.async_emit:
            self._raise_emit_error()
            with self._emit_cond:
                # Bounded hand-off, and the pinned buffer this window is
                # copied into is free: at most one window is still queued.
                while self._emit_pending >= 2 and not self._emit_stop:
                    self._emit_cond.wait(0.5)
        host_window = self.window_to_host()
        t1 = time.monotonic()
        episodes = self._emit(host_window, version, born_ns)
        t2 = time.monotonic()
        steps = self.num_envs * self.unroll_length
        self._m_steps.inc(steps)
        self._m_dispatches.inc()
        self._m_dispatch_s.observe(t1 - t0)
        if not self.async_emit:
            (self._m_encode_s if self.columnar_wire else self._m_unstack_s).observe(t2 - t1)
        return {"steps": steps, "episodes": episodes,
                "dispatch_s": t1 - t0, "unstack_s": t2 - t1,
                "encode_s": t2 - t1 if self.columnar_wire else 0.0,
                "wire": "columnar" if self.columnar_wire else "records"}

    def _emit(self, host_window: dict, version: int,
              born_ns: int = 0) -> int:
        """Hand a host window to the wire: stamp ``bver`` (the whole window
        is one model version, so the stamp is a fill), then the emitter
        thread, the columnar frames or the per-record streams. Returns the
        episodes completed (0 with ``async_emit``: they surface through
        :attr:`episode_returns`)."""
        if self.record_bver:
            host_window = dict(host_window)
            host_window["aux"] = dict(host_window["aux"])
            host_window["aux"]["bver"] = np.full(
                (self.num_envs, self.unroll_length), version, np.int32)
        if self.async_emit:
            with self._emit_cond:
                self._emit_queue.append((born_ns, host_window))
                self._emit_pending += 1
                self._emit_cond.notify_all()
            return 0
        self._window_born_ns = born_ns
        if self.columnar_wire:
            return self._emit_columnar(host_window)
        return self._unstack(host_window)

    # -- off-thread emitter (async_emit=True) --
    def start_emitter(self) -> None:
        """(Re)start the async emitter thread: a no-op when ``async_emit``
        is off or it is already running (the re-enable half of
        :meth:`close`)."""
        if not self.async_emit or self._emit_thread is not None:
            return
        self._emit_stop = False
        self._emit_thread = threading.Thread(
            target=self._emit_loop, name="anakin-emitter", daemon=True)
        self._emit_thread.start()

    def _emit_loop(self) -> None:
        while True:
            with self._emit_cond:
                while not self._emit_queue and not self._emit_stop:
                    self._emit_cond.wait(0.5)
                if self._emit_stop and not self._emit_queue:
                    return
                born_ns, w = self._emit_queue.pop(0)
            self._window_born_ns = born_ns  # single emitter thread
            t0 = time.monotonic()
            try:
                if self.columnar_wire:
                    self._emit_columnar(w)
                    self._m_encode_s.observe(time.monotonic() - t0)
                else:
                    self._unstack(w)
                    self._m_unstack_s.observe(time.monotonic() - t0)
            except Exception as e:
                # Surfaced on the next rollout() or flush_emits().
                self._emit_error = e
            finally:
                with self._emit_cond:
                    self._emit_pending -= 1
                    self._emit_cond.notify_all()

    def _raise_emit_error(self) -> None:
        if self._emit_error is not None:
            err, self._emit_error = self._emit_error, None
            raise RuntimeError(f"anakin emitter thread failed: {err!r}") from err

    def flush_emits(self, timeout_s: float = 30.0) -> bool:
        """Drain the async emitter's queue (no-op without ``async_emit``);
        True when drained in time. A pending emit failure raises here."""
        if not self.async_emit:
            return True
        deadline = time.monotonic() + timeout_s
        drained = True
        with self._emit_cond:
            while self._emit_pending > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    drained = False
                    break
                self._emit_cond.wait(min(0.5, remaining))
        self._raise_emit_error()
        return drained

    def close(self, timeout_s: float = 30.0) -> None:
        """Stop the emitter thread after draining its queue."""
        if self._emit_thread is None:
            return
        self.flush_emits(timeout_s)
        with self._emit_cond:
            self._emit_stop = True
            self._emit_cond.notify_all()
        self._emit_thread.join(timeout=5)
        self._emit_thread = None

    # -- the unstacker (the JAX host's, on numpy windows) --
    @staticmethod
    def _cat(chunks: list) -> np.ndarray:
        return chunks[0] if len(chunks) == 1 else np.concatenate(chunks)

    def _emit_columnar(self, w: dict) -> int:
        """Columnar wire: each completed per-lane segment of the host window
        ships as one frame (types/columnar.py) in the folded form the
        server's decoder produces from the per-record wire: the final step
        carries its full reward, ``t``/``x`` mark the terminal (terminated
        beats truncated), ``u`` mirrors ``reward_updated`` (zero on the
        terminal step), and a pure time-limit ending ships the pre-reset
        observation as ``final_obs``."""
        term, trunc = w["term"], w["trunc"]
        done = np.logical_or(term, trunc)
        episodes = 0
        for lane in range(self.num_envs):
            start = 0
            for b in np.flatnonzero(done[lane]).tolist():
                self._append_segment(lane, w, start, b + 1)
                terminated = bool(term[lane, b])
                self._flush_frame(
                    lane, ended=True, truncated=not terminated,
                    final=(None if terminated else
                           np.asarray(w["final_obs"][lane, b], np.float32)))
                episodes += 1
                start = b + 1
            if start < self.unroll_length:
                # The trailing segment outlives this window's host buffer.
                self._append_segment(lane, w, start, self.unroll_length, keep=True)
        if self.emit_coalesce > 1:
            # Window-end flush: coalescing trades sends for latency bounded
            # by one window.
            for lane in range(self.num_envs):
                self._flush_coalesced(lane)
        return episodes

    def _flush_coalesced(self, lane: int) -> None:
        """Ship the lane's pending frames as one send: one frame verbatim,
        several in a BATCH_KIND_FRAMES container (one spool entry)."""
        buf = self._coalesce_buf[lane]
        if not buf:
            return
        if len(buf) == 1:
            payload = buf[0]
        else:
            from relayrl_tpu_torch.transport.base import BATCH_KIND_FRAMES, pack_batch

            payload = pack_batch(BATCH_KIND_FRAMES, buf)
        buf.clear()
        if self._on_send is not None:
            self._m_sends.inc()
            self._on_send(lane, payload)

    def _append_segment(self, lane: int, w: dict, a: int, b: int,
                        keep: bool = False) -> None:
        """Stash window slice ``[a, b)`` on the lane's pending columns,
        flushing max_traj_length-sized chunks exactly where the per-record
        path would. ``keep`` copies the slices (they outlive the window)."""
        p = self._pending[lane]
        cols, aux_p = p["cols"], p["aux"]
        take = (lambda x: x.copy()) if keep else (lambda x: x)
        while a < b:
            if p["len"] >= self.max_traj_length:
                self._flush_frame(lane, ended=False)
            stop = min(b, a + self.max_traj_length - p["len"])
            cols["o"].append(take(w["obs"][lane, a:stop]))
            cols["a"].append(take(w["act"][lane, a:stop]))
            cols["r"].append(take(w["rew"][lane, a:stop]))
            for k, v in w["aux"].items():
                aux_p.setdefault(k, []).append(take(v[lane, a:stop]))
            p["len"] += stop - a
            self._ep_ret[lane] += float(np.sum(w["rew"][lane, a:stop], dtype=np.float64))
            a = stop

    def _flush_frame(self, lane: int, ended: bool, truncated: bool = False,
                     final=None) -> None:
        p = self._pending[lane]
        n = p["len"]
        if n == 0:
            return
        r = self._cat(p["cols"]["r"])
        t_col = np.zeros(n, np.uint8)
        x_col = np.zeros(n, np.uint8)
        u_col = (r != 0.0).astype(np.uint8)
        if ended:
            t_col[-1] = 1
            u_col[-1] = 0
            if truncated:
                x_col[-1] = 1
        time_limited = bool(ended and truncated)
        dt = DecodedTrajectory(
            agent_id="",  # attribution rides the transport envelope
            n_steps=n, n_records=n + (1 if ended else 0),
            marker_truncated=time_limited,
            columns={"o": self._cat(p["cols"]["o"]), "a": self._cat(p["cols"]["a"]),
                     "r": r, "t": t_col, "u": u_col, "x": x_col},
            aux={k: self._cat(chunks) for k, chunks in p["aux"].items()},
            final_obs=final if time_limited else None)
        from relayrl_tpu_torch.telemetry import trace as trace_mod

        if trace_mod.get_tracer().enabled:
            enc0 = time.monotonic_ns()
            frame = encode_columnar_frame(dt)
            self._last_emit_stamps = (self._window_born_ns or enc0,
                                      enc0, time.monotonic_ns())
        else:
            frame = encode_columnar_frame(dt)
        self._m_frames.inc()
        self._m_frame_bytes.inc(len(frame))
        if self.emit_coalesce > 1:
            buf = self._coalesce_buf[lane]
            buf.append(frame)
            if len(buf) >= self.emit_coalesce:
                self._flush_coalesced(lane)
        elif self._on_send is not None:
            self._m_sends.inc()
            self._on_send(lane, frame)
        if ended:
            self.episode_returns[lane].append(float(self._ep_ret[lane]))
            self._ep_ret[lane] = 0.0
        p["len"] = 0
        for chunks in p["cols"].values():
            chunks.clear()
        for chunks in p["aux"].values():
            chunks.clear()

    def _unstack(self, w: dict) -> int:
        """Per-record wire (``columnar_wire=False``): replay one host window
        into the per-lane trajectories in the live loop's wire shape:
        reward r_t on the record of the action that earned it
        (``reward_updated`` only for nonzero rewards), the final action of
        an episode keeps rew=0 with its reward on the terminal marker,
        terminated beats truncated, and a pure time-limit ending ships the
        pre-reset observation for the value bootstrap."""
        obs, act, rew = w["obs"], w["act"], w["rew"]
        term, trunc, final_obs = w["term"], w["trunc"], w["final_obs"]
        aux_items = list(w["aux"].items())
        done = np.logical_or(term, trunc)
        episodes = 0
        for lane in range(self.num_envs):
            traj = self.trajectories[lane]
            obs_l, act_l = obs[lane], act[lane]
            rew_l = rew[lane].tolist()
            aux_l = [(k, v[lane]) for k, v in aux_items]

            def seg_records(a, b, last_masked, keep=False, _obs_l=obs_l, _act_l=act_l,
                            _rew_l=rew_l, _aux_l=aux_l):
                # last_masked: the index whose record keeps rew=0 (the
                # terminal step), -1 for an unterminated trailing segment,
                # whose records outlive the window's host buffer (keep).
                return [ActionRecord(
                    obs=_obs_l[t].copy() if keep else _obs_l[t],
                    act=np.array(_act_l[t]),
                    mask=None,
                    rew=0.0 if t == last_masked else _rew_l[t],
                    reward_updated=bool(t != last_masked and _rew_l[t] != 0.0),
                    data={k: np.array(v[t]) for k, v in _aux_l},
                    done=False,
                ) for t in range(a, b)]

            start = 0
            for b in np.flatnonzero(done[lane]).tolist():
                records = seg_records(start, b + 1, last_masked=b)
                terminated = bool(term[lane, b])
                time_limited = not terminated
                records.append(ActionRecord(
                    obs=(np.asarray(final_obs[lane, b], np.float32)
                         if time_limited else None),
                    rew=rew_l[b], done=True, truncated=time_limited))
                traj.add_actions(records)
                self._ep_ret[lane] += float(np.sum(rew[lane, start:b + 1], dtype=np.float64))
                self.episode_returns[lane].append(float(self._ep_ret[lane]))
                self._ep_ret[lane] = 0.0
                episodes += 1
                start = b + 1
            if start < self.unroll_length:
                traj.add_actions(seg_records(start, self.unroll_length, last_masked=-1,
                                             keep=True))
                self._ep_ret[lane] += float(np.sum(rew[lane, start:], dtype=np.float64))
        return episodes

    # -- model hot-swap (one gate, all lanes, whole windows) --
    def maybe_swap(self, bundle: ModelBundle) -> bool:
        """Install a newer model for every lane atomically; the window in
        flight finishes on the old version, the next reads the new one."""
        return apply_bundle_swap(self, bundle)

    def swap_from_bytes(self, buf: bytes) -> bool:
        return self.maybe_swap(ModelBundle.from_bytes(buf))

    def swap_from_wire(self, version: int, blob: bytes):
        """Wire-v2-aware swap shared with the other actor hosts."""
        return apply_wire_swap(self, version, blob)


def run_anakin_loop(host, windows: int) -> list[list[float]]:
    """Drive ``windows`` fused windows through an :class:`AnakinActorHost`
    (or the networked anakin-mode ``VectorAgent``: the same ``rollout()``
    surface). Returns per-lane completed episode returns."""
    for _ in range(windows):
        host.rollout()
    anakin = getattr(host, "host", host)  # the networked facade's host
    anakin.flush_emits()
    return [list(r) for r in anakin.episode_returns]
