"""Actor-side policy holder: inference + ActionRecord assembly + hot-swap.

Counterpart of :mod:`relayrl_tpu.runtime.policy_actor`. A per-step policy
(the MLP families) acts on each observation alone; a sequence policy acts
from a rolling observation-history window. A transformer serves through
its KV cache by default (``use_kv_cache=True``), one decode step per env
step, with the reference's rules: the cache is rebuilt by one prefill
from the stored window after a hot swap (and started fresh at an
episode's first step), dropped at an episode boundary, and dropped when
the window starts rolling or the greedy path advances the window; the
window path, one forward over the padded window, serves then, and always
for ``use_kv_cache=False``. A networked agent's model deliveries go
through :func:`apply_wire_swap` (model-wire v2 frames, or v1 bundles);
plain integer counters stand in for the telemetry counters and trace
hooks.

Records carry what the JAX actors put on the wire: ``act`` an int32 array
(discrete) or a float32 vector (continuous), ``logp_a`` and ``v`` float32
0-d arrays, so per-record bytes match.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from relayrl_tpu_torch.models import build_policy, validate_policy
from relayrl_tpu_torch.types.action import ActionRecord
from relayrl_tpu_torch.types.model_bundle import (
    ModelBundle,
    arch_equal,
    exploration_kwargs,
)
from relayrl_tpu_torch.types.trajectory import Trajectory


def resolve_actor_context(arch) -> int:
    """Serving-window length for sequence policies: the model's full
    context unless ``actor_context`` narrows it. Shared by PolicyActor
    and VectorActorHost so the positional-table guard can never drift
    between the single and batched serving paths."""
    max_seq = int(arch.get("max_seq_len", 1024))
    ctx = int(arch.get("actor_context", max_seq))
    if ctx > max_seq:
        raise ValueError(
            f"actor_context {ctx} exceeds the model's max_seq_len "
            f"{max_seq} (positional table size)")
    return ctx


def push_window(window: np.ndarray, length: int, obs) -> tuple[int, bool]:
    """Advance one rolling observation-history window in place: write
    ``obs`` at ``length`` while the window is filling, else shift left by
    one and write at the end. Returns ``(new_length, rolled)``. The one
    window-advance rule every actor tier goes through."""
    cap = window.shape[0]
    if length < cap:
        window[length] = obs
        return length + 1, False
    window[:-1] = window[1:]  # rolling: drop the oldest
    window[-1] = obs
    return cap, True


def apply_bundle_swap(actor, bundle: ModelBundle, flat: bool = False) -> bool:
    """Shared hot-swap gate: version check, arch-ABI guard, params
    install under the actor's lock. PolicyActor and VectorActorHost
    delegate here (attribute contract: ``version``, ``arch``, ``params``,
    ``policy``, ``_explore_kwargs``, ``_lock``, ``swaps``). The new
    weights are built and copied to the device before the lock is taken,
    so a dispatch in flight waits only for the pointer swap. ``flat``
    moves them in one host-to-device copy into a clone of the live module
    (the wire path) instead of one copy per leaf."""
    if bundle.version <= actor.version:
        return False
    if not arch_equal(bundle.arch, actor.arch):
        raise ValueError(
            f"model arch changed {actor.arch} -> {bundle.arch}; "
            "actor refuses hot-swap (param-ABI guard)")
    if flat:
        import copy

        from relayrl_tpu_torch.weights import load_flat, params_from_jax

        params = load_flat(copy.deepcopy(actor.params),
                           params_from_jax(bundle.params))
    else:
        params = actor.policy.load_params(bundle.params)
    with actor._lock:
        if bundle.version <= actor.version:  # a newer swap won the race
            return False
        if dict(bundle.arch) != actor.arch:
            # Exploration knobs changed: only their values refresh.
            actor.arch = dict(bundle.arch)
            actor._explore_kwargs = exploration_kwargs(actor.arch)
        actor.params = params
        actor.version = bundle.version
        actor.swaps += 1
    return True


def apply_wire_swap(actor, version: int, blob: bytes):
    """Shared model-delivery decode + swap for both actor hosts: sniffs
    model-wire v2 frames vs v1 bundles and returns the installed
    :class:`ModelBundle` (or None when nothing was installed).

    v2: the frame applies into the actor's
    :class:`~relayrl_tpu_torch.transport.modelwire.ModelWireDecoder`
    preallocated host buffers; the params then reach the device through
    ONE host-to-device copy (:func:`~relayrl_tpu_torch.weights.load_flat`
    into a clone of the live module, built before the gate's lock), and
    :func:`apply_bundle_swap` installs them. Only bytes move, so the
    installed params equal the published ones bit for bit. The decoder's
    buffers are its live delta targets: the copy out of them happens
    before the next frame is decoded on the same listener thread.

    v1: the bundle installs as before, and reseeds the decoder so a
    mixed-version fleet keeps the wire state coherent.

    Raises :class:`~relayrl_tpu_torch.transport.modelwire.WireBaseMismatch`
    (once per divergence) so the transport owner can request a resync.
    """
    from relayrl_tpu_torch.transport import modelwire
    from relayrl_tpu_torch.weights import params_to_jax

    if not modelwire.is_wire_frame(blob):
        bundle = ModelBundle.from_bytes(blob)
        bundle.version = version
        if not apply_bundle_swap(actor, bundle):
            return None
        if actor._wire_decoder is not None:
            actor._wire_decoder.seed(bundle.version, bundle.arch,
                                     bundle.params)
        return bundle
    dec = actor._wire_decoder
    if dec is None:
        dec = actor._wire_decoder = modelwire.ModelWireDecoder()
        dec.seed(actor.version, actor.arch, params_to_jax(actor.params))
    out = dec.decode(blob)
    if out is None:
        return None  # stale duplicate, or awaiting a keyframe after resync
    ver, arch, host_tree = out
    bundle = ModelBundle(version=ver, arch=arch, params=host_tree)
    return bundle if apply_bundle_swap(actor, bundle, flat=True) else None


def normalize_obs(obs) -> np.ndarray:
    """The one wire-dtype rule for observations entering any actor tier:
    byte frames stay bytes (with a defensive copy — envs commonly hand
    out views of a reused frame buffer), everything else float32."""
    obs = np.asarray(obs)
    return (obs.copy() if obs.dtype == np.uint8
            else obs.astype(np.float32, copy=False))


def _act_to_host(act: torch.Tensor) -> np.ndarray:
    """Actions as the JAX actors ship them: int32 (discrete) or float32
    (continuous)."""
    return act.to(torch.float32 if act.is_floating_point() else torch.int32).cpu().numpy()


def _to_host(act: torch.Tensor, aux: dict[str, torch.Tensor]):
    """Batched step outputs -> (actions [N, ...], {key: float32 [N]})."""
    return (_act_to_host(act),
            {k: a.to(torch.float32).cpu().numpy() for k, a in aux.items()})


def make_batched_step(policy):
    """Sampling step over stacked per-lane observations, each lane acting
    on its observation alone (a sequence policy's context of one):
    ``fn(params, generator, obs[N, ...], masks, explore) -> (acts[N, ...],
    {logp_a, v: [N] float32})`` as numpy, actions int32 (discrete) or
    float32 (continuous). ``masks`` is None or ``[N, act_dim]``;
    ``explore`` is the :func:`exploration_kwargs` dict."""
    # A sequence policy reads the second-to-last axis as time.
    sequence = policy.step_window is not None

    def fn(params, generator, obs, masks, explore):
        obs = torch.as_tensor(obs, dtype=torch.float32, device=policy.device)
        if masks is not None:
            masks = torch.as_tensor(masks, dtype=torch.float32, device=policy.device)
        if sequence:
            obs = obs[:, None]
            masks = None if masks is None else masks[:, None]
        with torch.inference_mode():
            act, aux = policy.step(params, generator, obs, masks, **explore)
        return _to_host(act, aux)
    return fn


def make_cached_step(policy):
    """:attr:`Policy.step_cached` for one episode: ``fn(params, generator,
    cache, obs, t, mask) -> (acts [1] int32, {logp_a, v: [1] float32},
    cache)`` as numpy, shaped as :func:`make_batched_window_step`'s
    batch of one. It draws from ``generator`` exactly as the window step
    does, so the two give the same actions where their logits agree."""
    def fn(params, generator, cache, obs, t, mask):
        with torch.inference_mode():
            act, aux, cache = policy.step_cached(params, generator, cache,
                                                 obs, t, mask)
        act, aux = _to_host(act.reshape(1), {k: a.reshape(1) for k, a in aux.items()})
        return act, aux, cache
    return fn


def make_batched_window_step(policy):
    """:attr:`Policy.step_window` over stacked per-lane windows:
    ``fn(params, generator, windows[N,W,obs], ts[N], masks) -> (acts[N]
    int32, {logp_a, v: [N] float32})`` as numpy. One forward serves every
    lane whatever its episode position; a single actor calls it with
    N = 1, so a batch of one is the single actor bit for bit."""
    def fn(params, generator, windows, ts, masks):
        with torch.inference_mode():
            act, aux = policy.step_window(params, generator, windows, ts,
                                          masks)
        return _to_host(act, aux)
    return fn


class PolicyActor:
    """Local policy + current trajectory; thread-safe hot-swap.

    ``device`` defaults to the GPU; without one the caller must pass
    ``device="cpu"``. ``seed`` seeds the actor's sampling generator.
    ``use_kv_cache`` serves a policy that has a KV cache through it (see
    the module note)."""

    def __init__(
        self,
        bundle: ModelBundle,
        max_traj_length: int = 1000,
        on_send=None,
        seed: int = 0,
        validate: bool = True,
        device=None,
        use_kv_cache: bool = True,
    ):
        self._lock = threading.Lock()
        self.arch = dict(bundle.arch)
        self.policy = build_policy(self.arch, device)
        self.params = self.policy.load_params(bundle.params)
        if validate:
            validate_policy(self.policy, self.params)
        self.version = bundle.version
        self._step_fn = make_batched_step(self.policy)
        self._window_fn = None
        self._window = None
        self._window_len = 0
        if self.policy.step_window is not None:
            ctx = resolve_actor_context(self.arch)
            self._window = np.zeros((ctx, int(self.arch["obs_dim"])),
                                    np.float32)
            self._window_fn = make_batched_window_step(self.policy)
        # The KV cache: O(W) per step instead of the window path's full
        # recompute. The window is kept beside it as the source of a
        # rebuild (after a hot swap the cache holds the old params' k and
        # v) and as the path once the window rolls (positions shift).
        self._cached_fn = None
        self._prefill_fn = None
        self._cache = None
        self._cache_version = -1
        if (use_kv_cache and self.policy.step_cached is not None
                and self.policy.prefill_cache is not None
                and self._window is not None):
            self._cached_fn = make_cached_step(self.policy)
            self._prefill_fn = self.policy.prefill_cache
        self._explore_kwargs = exploration_kwargs(self.arch)
        self._generator = torch.Generator(
            device=self.policy.device).manual_seed(seed)
        self.trajectory = Trajectory(max_length=max_traj_length, on_send=on_send)
        self.steps_served = 0
        self.swaps = 0
        # Model-wire v2 decode state, created on the first v2 frame.
        self._wire_decoder = None

    def request_for_action(self, obs, mask=None,
                           reward: float = 0.0) -> ActionRecord:
        """Run the policy, append the step to the current trajectory.

        ``reward`` is the env reward earned since the previous request; it
        is attached to the PREVIOUS record so ``ActionRecord.rew`` always
        means "reward earned BY this action"."""
        obs = normalize_obs(obs)
        mask_arr = None if mask is None else np.asarray(mask, dtype=np.float32)
        with self._lock:
            if reward and self.trajectory.get_actions():
                self.trajectory.get_actions()[-1].update_reward(float(reward))
            masks = None if mask_arr is None else mask_arr[None]
            if self._window_fn is not None:
                rolled = self._push_window(obs)
                if self._cached_fn is not None and not rolled:
                    t = self._window_len - 1
                    if self._cache is None or self._cache_version != self.version:
                        self._rebuild_cache(t)
                    acts, aux, self._cache = self._cached_fn(
                        self.params, self._generator, self._cache, obs, t,
                        mask_arr)
                else:
                    self._cache = None  # rolling: positions shifted
                    acts, aux = self._window_fn(
                        self.params, self._generator, self._window[None],
                        np.array([self._window_len]), masks)
            else:
                acts, aux = self._step_fn(
                    self.params, self._generator, obs[None], masks,
                    self._explore_kwargs)
            record = ActionRecord(
                obs=obs,
                act=np.asarray(acts[0]),
                mask=mask_arr,
                rew=0.0,  # filled by the NEXT request / terminal marker
                data={k: np.asarray(v[0]) for k, v in aux.items()},
                done=False,
            )
            self.trajectory.add_action(record, send_if_done=True)
            self.steps_served += 1
        return record

    def flag_last_action(
        self,
        reward: float = 0.0,
        truncated: bool = False,
        final_obs=None,
        terminated: bool | None = None,
        final_mask=None,
    ) -> None:
        """Terminal marker: appends a done action carrying the final
        reward, which triggers the trajectory send. ``truncated=True``
        marks a time-limit ending; a genuine ``terminated`` wins when both
        are set."""
        if terminated:
            truncated = False
        with self._lock:
            if self._window is not None:
                # Episode boundary: the next episode must not attend this
                # one's observations.
                self._window[:] = 0.0
                self._window_len = 0
                self._cache = None
            record = ActionRecord(
                obs=(None if final_obs is None
                     else np.asarray(final_obs, np.float32)),
                mask=(None if final_mask is None
                      else np.asarray(final_mask, np.float32)),
                rew=float(reward), done=True, truncated=bool(truncated))
            self.trajectory.add_action(record, send_if_done=True)

    def record_action(self, action: ActionRecord) -> None:
        """Append an externally-chosen action."""
        with self._lock:
            self.trajectory.add_action(action, send_if_done=True)

    def maybe_swap(self, bundle: ModelBundle) -> bool:
        """Install a newer model; stale or arch-mismatched bundles are
        rejected."""
        return apply_bundle_swap(self, bundle)

    def swap_from_bytes(self, buf: bytes) -> bool:
        return self.maybe_swap(ModelBundle.from_bytes(buf))

    def swap_from_wire(self, version: int, blob: bytes):
        """Install a model delivery (a v2 frame or a v1 bundle); returns
        the installed bundle or None (see :func:`apply_wire_swap`)."""
        return apply_wire_swap(self, version, blob)

    def _push_window(self, obs: np.ndarray) -> bool:
        """Append one observation to the rolling history (lock held).
        Returns True once the window has started rolling."""
        self._window_len, rolled = push_window(
            self._window, self._window_len, obs)
        return rolled

    def _rebuild_cache(self, t: int) -> None:
        """A fresh cache, refilled from the stored window by one prefill
        when the episode has earlier positions (lock held): after a hot
        swap, or at an episode's first cached step (t = 0, nothing to
        refill). Masks are not replayed: they gate the readout's logits,
        never the k and v rows."""
        with torch.inference_mode():
            self._cache = self.policy.init_cache(self._window.shape[0])
            if t > 0:
                self._cache = self._prefill_fn(self.params, self._cache,
                                               self._window)
        self._cache_version = self.version

    def reset_episode(self) -> None:
        """Reset per-episode serving state (history window and KV cache)
        WITHOUT touching the trajectory — the episode boundary for eval
        loops."""
        with self._lock:
            if self._window is not None:
                self._window[:] = 0.0
                self._window_len = 0
            self._cache = None

    def deterministic_action(self, obs, mask=None) -> np.ndarray:
        """Greedy action (int32, or float32 for a continuous policy). For
        sequence policies this ADVANCES the history window; call
        flag_last_action or reset_episode at episode end to reset it."""
        obs_arr = np.asarray(obs, np.float32)
        mask_arr = None if mask is None else np.asarray(mask, np.float32)
        with self._lock, torch.inference_mode():
            if self.policy.mode_window is not None:
                self._push_window(obs_arr)
                # The greedy path advances the window but not the cache:
                # drop it, so the sampling path rebuilds it with every
                # position present.
                self._cache = None
                act = self.policy.mode_window(self.params, self._window,
                                              self._window_len, mask_arr)
            else:
                act = self.policy.mode(self.params, obs_arr, mask_arr)
            return _act_to_host(act)

