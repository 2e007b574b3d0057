"""The agent (actor) process: local policy inference + trajectory streaming
+ model hot-swap.

Counterpart of :mod:`relayrl_tpu.runtime.agent`. Bring-up is the JAX
agent's handshake: fetch the model, validate it with a dummy forward,
persist it to the ``client_model`` path, bind the trajectory spool,
register, start the model listener. Model deliveries go through the
actor's wire-aware swap (model-wire v2 frames or v1 bundles); a delta
whose base diverged requests a resync. Every trajectory goes out through a
:class:`~relayrl_tpu_torch.runtime.spool.TrajectorySpool` with a sequence
tag, and the spool replays its retained window when the transport heals,
so with the server's dedup ledger the loop is exactly-once across a
learner crash.

``Agent`` wraps a :class:`~relayrl_tpu_torch.runtime.policy_actor.
PolicyActor`; ``VectorAgent`` a :class:`~relayrl_tpu_torch.runtime.
vector_actor.VectorActorHost` whose N lanes register as N logical agents
over one connection, or, with ``host_mode="anakin"``, a
:class:`~relayrl_tpu_torch.runtime.anakin.AnakinActorHost` whose lanes step
an on-device env (``actor.jax_env``) inside one fused window per
:meth:`VectorAgent.rollout`. Both take ``device`` (default: the GPU;
without one the caller must pass ``device="cpu"``) and ``server_type``
("zmq", "grpc", "native" or "auto", which negotiates against the live
server as the JAX agent does). Not ported: the tracing hooks and the
fleet snapshot emitter (``ROADMAP.md`` queue 1 item 12).
"""

from __future__ import annotations

import os

import numpy as np

from relayrl_tpu_torch.config import ConfigLoader
from relayrl_tpu_torch.types.action import ActionRecord
from relayrl_tpu_torch.types.model_bundle import ModelBundle


def _deliver_model(actor_host, transport, client_model_path: str, tag: str,
                   version: int, blob: bytes) -> None:
    """Shared model-delivery handler for Agent and VectorAgent: the
    wire-aware swap, a resync request on a base mismatch (raised once per
    divergence), isolation of any other decode/validation failure, and
    the client-model persist on install."""
    from relayrl_tpu_torch.transport.modelwire import WireBaseMismatch

    try:
        installed = actor_host.swap_from_wire(version, blob)
    except WireBaseMismatch as e:
        from relayrl_tpu_torch import telemetry

        telemetry.emit("model_resync", agent_id=transport.identity,
                       base=e.base, held=e.held, side="agent")
        transport.request_resync(e.held)
        return
    except Exception as e:
        print(f"[{tag}] rejected model update: {e!r}", flush=True)
        return
    if installed is not None:
        try:
            installed.save(client_model_path)
        except OSError:
            pass


def _bind_spool_impl(owner, name: str) -> None:
    """Create (first enable) or re-bind (restart) the owner's trajectory
    spool. The spool survives ``restart_agent`` with its seq counters and
    retained window; its send hook is re-bound to the fresh transport.
    ``actor.spool_entries: 0`` disables it (untagged direct sends)."""
    params = owner.config.get_actor_params()
    if params["spool_entries"] <= 0:
        owner.spool = None
        return

    def send_fn(payload: bytes, tagged_id: str) -> None:
        owner.transport.send_trajectory(payload, agent_id=tagged_id)

    if owner.spool is None:
        from relayrl_tpu_torch.runtime.spool import TrajectorySpool
        from relayrl_tpu_torch.transport.retry import breaker_from_config

        retry_cfg = owner.config.get_transport_params()["retry"]
        owner.spool = TrajectorySpool(
            send_fn=send_fn,
            max_entries=params["spool_entries"],
            max_bytes=params["spool_bytes"],
            directory=params["spool_dir"],
            name=name,
            breaker=breaker_from_config(f"agent:{name}", retry_cfg),
        )
        if params["spool_dir"] and owner.spool.depth:
            # A prior process life left trajectories in flight: replay
            # them now that a transport is live.
            owner.spool.replay()
    else:
        owner.spool.send_fn = send_fn


def _handle_reconnect_impl(owner, agent_ids: list[str]) -> None:
    """Transport-heal handler: re-register every logical agent and replay
    the spool window (the server's dedup makes the replay exactly-once).
    Runs on a transport thread."""
    from relayrl_tpu_torch import telemetry

    for agent_id in agent_ids:
        try:
            owner.transport.register(agent_id, timeout_s=5.0)
        except Exception as e:
            print(f"[Agent] re-register {agent_id!r} after reconnect "
                  f"failed: {e!r}", flush=True)
    replayed = owner.spool.replay() if owner.spool is not None else 0
    telemetry.emit("agent_reconnect",
                   agent_id=agent_ids[0] if agent_ids else "?",
                   lanes=len(agent_ids), replayed=replayed)


def _send_direct(transport, payload: bytes, agent_id: str) -> None:
    """Spool-less send (``actor.spool_entries: 0``): a guardrail nack has
    nothing to retain or replay, so it is dropped, never raised into the
    env loop."""
    from relayrl_tpu_torch.transport.base import IngestNack

    try:
        transport.send_trajectory(payload, agent_id=agent_id)
    except IngestNack:
        pass


def _fetch_bundle(owner) -> tuple[int, ModelBundle]:
    """Handshake: the server's current model, persisted before loading."""
    version, bundle_bytes = owner.transport.fetch_model(
        owner._handshake_timeout_s)
    bundle = ModelBundle.from_bytes(bundle_bytes)
    bundle.version = version
    try:
        bundle.save(owner.client_model_path)
    except OSError:
        pass
    return version, bundle


def _load_kernels(device) -> None:
    """On the GPU, build and load every kernel library before the first
    dispatch, so a kernel that fails to build fails the agent's
    construction."""
    import torch

    from relayrl_tpu_torch.models import resolve_device

    if resolve_device(device).type == "cuda" and torch.cuda.is_available():
        from relayrl_tpu_torch import _kernels

        _kernels.build()
        for name in _kernels.KERNELS:
            _kernels.load(name)


class Agent:
    def __init__(
        self,
        model_path: str | None = None,
        config_path: str | None = None,
        server_type: str = "zmq",
        handshake_timeout_s: float = 60.0,
        seed: int | None = None,
        start: bool = True,
        device=None,
        **addr_overrides,
    ):
        self.config = ConfigLoader(None, config_path)
        from relayrl_tpu_torch import faults, telemetry

        telemetry.configure_from_config(self.config)
        faults.maybe_install_from_env()
        self.server_type = server_type
        self.device = device
        self._addr_overrides = addr_overrides
        self.client_model_path = model_path or self.config.get_client_model_path()
        self._handshake_timeout_s = handshake_timeout_s
        self._seed = os.getpid() if seed is None else seed
        self.actor = None
        self.transport = None
        self.spool = None  # TrajectorySpool, built on first enable
        self.active = False
        _load_kernels(device)
        if start:
            self.enable_agent()

    # -- bring-up / lifecycle --
    def enable_agent(self) -> None:
        if self.active:
            return
        from relayrl_tpu_torch.runtime.policy_actor import PolicyActor
        from relayrl_tpu_torch.transport import make_agent_transport

        self.transport = make_agent_transport(
            self.server_type, self.config, **dict(self._addr_overrides))
        version, bundle = _fetch_bundle(self)
        self._bind_spool()
        if self.actor is None:
            self.actor = PolicyActor(
                bundle,
                max_traj_length=self.config.get_max_traj_length(),
                on_send=self._send_traj,
                seed=self._seed,
                device=self.device,
            )
        else:
            self.actor.maybe_swap(bundle)
            self.actor.trajectory._on_send = self._send_traj
        if not self.transport.register(self.transport.identity):
            raise RuntimeError("agent registration (MODEL_SET/ID_LOGGED) failed")
        self.transport.on_model = self._on_model
        self.transport.on_reconnect = self._handle_reconnect
        self.transport.start_model_listener()
        self.active = True
        from relayrl_tpu_torch import telemetry

        telemetry.emit("agent_register", agent_id=self.transport.identity,
                       version=version, side="agent")

    def _send_traj(self, payload: bytes) -> None:
        if self.spool is not None:
            self.spool.send(payload, self.transport.identity)
        else:
            _send_direct(self.transport, payload, self.transport.identity)

    def _bind_spool(self) -> None:
        name = self._addr_overrides.get("identity") or "agent"
        _bind_spool_impl(self, name)

    def _handle_reconnect(self) -> None:
        _handle_reconnect_impl(self, [self.transport.identity])

    def disable_agent(self) -> None:
        if not self.active:
            return
        if self.spool is not None:
            # The spool outlives the transport; a send while disabled
            # buffers instead of touching a closed socket.
            self.spool.send_fn = None
        self.transport.close()
        self.transport = None
        self.active = False

    def restart_agent(self, **addr_overrides) -> None:
        from relayrl_tpu_torch import telemetry

        self.disable_agent()
        self._addr_overrides.update(addr_overrides)
        self.enable_agent()
        if self.spool is not None:
            self.spool.replay()
        telemetry.emit("agent_reconnect", agent_id=self.transport.identity)

    def _on_model(self, version: int, bundle_bytes: bytes) -> None:
        _deliver_model(self.actor, self.transport, self.client_model_path,
                       "Agent", version, bundle_bytes)

    # -- action API --
    def request_for_action(self, obs, mask=None, reward: float = 0.0) -> ActionRecord:
        self._require_active()
        return self.actor.request_for_action(obs, mask, reward)

    def flag_last_action(self, reward: float = 0.0, truncated: bool = False,
                         final_obs=None, terminated: bool | None = None,
                         final_mask=None) -> None:
        self._require_active()
        self.actor.flag_last_action(reward, truncated=truncated,
                                    final_obs=final_obs, terminated=terminated,
                                    final_mask=final_mask)

    def record_action(self, action: ActionRecord) -> None:
        self._require_active()
        self.actor.record_action(action)

    @property
    def model_version(self) -> int:
        return -1 if self.actor is None else self.actor.version

    def _require_active(self) -> None:
        if not self.active or self.actor is None:
            raise RuntimeError("agent is not active (call enable_agent())")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.disable_agent()


class VectorAgent:
    """Networked vector actor host: N logical agents over ONE connection.

    One process steps ``num_envs`` environment lanes through one batched
    policy dispatch and presents each lane to the training server as its
    own logical agent — N registry entries, N attributed trajectory
    streams, one socket, one model subscription, one atomic hot-swap.
    Agent-compatible lifecycle; the action surface is batched
    (``request_for_actions`` / per-lane ``flag_last_action``), or, on the
    anakin tier (``host_mode="anakin"``), :meth:`rollout`: the lanes step
    the on-device env ``jax_env`` (an id of ``envs.device.DEVICE_ENVS``,
    built with ``jax_env_kwargs``) for ``unroll_length`` steps per window.
    ``columnar_wire``, ``async_emit``, ``emit_coalesce_frames`` and
    ``window_size`` default to the ``actor`` config section's values
    (``columnar_wire: "auto"`` is columnar frames on the anakin tier, the
    per-record wire on the vector tier); ``record_bver`` stamps each
    record's model version into its aux. ``send_interceptor(lane, payload)``
    is offered every completed lane episode before the spool: a non-None
    return ships, None means the stage took the episode and will re-inject
    it through :meth:`emit_lane` (the RLHF score stage's seam).
    """

    def __init__(
        self,
        num_envs: int | None = None,
        model_path: str | None = None,
        config_path: str | None = None,
        server_type: str = "zmq",
        handshake_timeout_s: float = 60.0,
        seed: int | None = None,
        start: bool = True,
        identity: str | None = None,
        host_mode: str | None = None,
        device=None,
        jax_env: str | None = None,
        jax_env_kwargs: dict | None = None,
        unroll_length: int | None = None,
        columnar_wire: bool | None = None,
        async_emit: bool | None = None,
        emit_coalesce_frames: int | None = None,
        window_size: int | None = None,
        record_bver: bool = False,
        send_interceptor=None,
        **addr_overrides,
    ):
        self._send_interceptor = send_interceptor
        self.config = ConfigLoader(None, config_path)
        from relayrl_tpu_torch import faults, telemetry

        telemetry.configure_from_config(self.config)
        faults.maybe_install_from_env()
        actor_params = self.config.get_actor_params()
        self.num_envs = int(num_envs if num_envs is not None
                            else actor_params.get("num_envs", 1))
        if self.num_envs < 1:
            raise ValueError(f"num_envs must be >= 1, got {self.num_envs}")
        mode = str(host_mode if host_mode is not None
                   else actor_params["host_mode"])
        # A VectorAgent is the vector topology unless it runs the anakin
        # tier; "process" configs constructing one mean the batched default.
        self.host_mode = mode if mode == "anakin" else "vector"
        self.jax_env = str(jax_env if jax_env is not None else actor_params["jax_env"])
        self.jax_env_kwargs = dict(jax_env_kwargs or {})
        self.unroll_length = int(unroll_length if unroll_length is not None
                                 else actor_params["unroll_length"])
        self.window_size = (actor_params.get("window_size")
                            if window_size is None else window_size)
        self.record_bver = bool(record_bver)
        if columnar_wire is None:
            columnar_wire = actor_params.get("columnar_wire", "auto")
        self.columnar_wire = (self.host_mode == "anakin"
                              if not isinstance(columnar_wire, bool)
                              else bool(columnar_wire))
        self.async_emit = bool(actor_params.get("async_emit", False)
                               if async_emit is None else async_emit)
        self.emit_coalesce_frames = max(1, int(
            actor_params.get("emit_coalesce_frames", 1)
            if emit_coalesce_frames is None else emit_coalesce_frames))
        self.server_type = server_type
        self.device = device
        self._addr_overrides = addr_overrides
        self._identity = identity
        self.client_model_path = (model_path
                                  or self.config.get_client_model_path())
        self._handshake_timeout_s = handshake_timeout_s
        self._seed = os.getpid() if seed is None else seed
        self.host = None
        self.transport = None
        self.spool = None
        self.agent_ids: list[str] = []
        self.active = False
        _load_kernels(device)
        if start:
            self.enable_agent()

    def enable_agent(self) -> None:
        if self.active:
            return
        from relayrl_tpu_torch.runtime.vector_actor import VectorActorHost
        from relayrl_tpu_torch.transport import make_agent_transport

        overrides = dict(self._addr_overrides)
        if self._identity is not None:
            overrides.setdefault("identity", self._identity)
        self.transport = make_agent_transport(
            self.server_type, self.config, **overrides)
        version, bundle = _fetch_bundle(self)
        # Lane ids derive from the connection identity so a fleet of
        # vector hosts never collides; the server sees N distinct agents.
        self.agent_ids = [f"{self.transport.identity}.lane{k}"
                          for k in range(self.num_envs)]
        _bind_spool_impl(self, self._identity or "vector")
        if self.host is not None and hasattr(self.host, "start_emitter"):
            # Re-enable after a disable: the emitter thread was closed
            # with the transport.
            self.host.start_emitter()
        if self.host is None and self.host_mode == "anakin":
            from relayrl_tpu_torch.runtime.anakin import AnakinActorHost

            self.host = AnakinActorHost(
                bundle,
                env=self.jax_env,
                num_envs=self.num_envs,
                unroll_length=self.unroll_length,
                max_traj_length=self.config.get_max_traj_length(),
                on_send=self._send_lane,
                seed=self._seed,
                columnar_wire=self.columnar_wire,
                async_emit=self.async_emit,
                emit_coalesce_frames=self.emit_coalesce_frames,
                window_size=self.window_size,
                record_bver=self.record_bver,
                device=self.device,
                **self.jax_env_kwargs,
            )
        elif self.host is None:
            self.host = VectorActorHost(
                bundle,
                num_envs=self.num_envs,
                max_traj_length=self.config.get_max_traj_length(),
                on_send=self._send_lane,
                seed=self._seed,
                device=self.device,
            )
        else:
            self.host.maybe_swap(bundle)
        for agent_id in self.agent_ids:
            if not self.transport.register(agent_id):
                raise RuntimeError(
                    f"logical-agent registration failed for {agent_id!r}")
        self.transport.on_model = self._on_model
        self.transport.on_reconnect = (
            lambda: _handle_reconnect_impl(self, self.agent_ids))
        self.transport.start_model_listener()
        self.active = True
        from relayrl_tpu_torch import telemetry

        telemetry.emit("agent_register", agent_id=self.transport.identity,
                       lanes=self.num_envs, version=version, side="agent")

    def disable_agent(self) -> None:
        if not self.active:
            return
        if hasattr(self.host, "close"):
            # An async-emit anakin host drains its queued windows onto the
            # wire and stops its emitter; enable_agent restarts it.
            self.host.close()
        if self.spool is not None:
            self.spool.send_fn = None  # see Agent.disable_agent
        self.transport.close()
        self.transport = None
        self.active = False

    def _send_lane(self, lane: int, payload: bytes) -> None:
        if self._send_interceptor is not None:
            payload = self._send_interceptor(lane, payload)
            if payload is None:
                return  # the stage owns it now; emit_lane re-injects
        self.emit_lane(lane, payload)

    def emit_lane(self, lane: int, payload: bytes) -> None:
        """Ship one lane's serialized episode through the spool or straight
        to the transport: the re-injection surface of a
        ``send_interceptor`` stage. Spool sequence numbers are assigned
        here, so a withheld episode enters the at-least-once window only
        once it is final: a replay after a crash redelivers the scored
        bytes, never the unscored ones."""
        if self.spool is not None:
            self.spool.send(payload, self.agent_ids[lane])
        else:
            _send_direct(self.transport, payload, self.agent_ids[lane])

    def _on_model(self, version: int, bundle_bytes: bytes) -> None:
        # ONE receipt serves all lanes: a single wire-aware swap
        # atomically installs the new params for the whole batch.
        _deliver_model(self.host, self.transport, self.client_model_path,
                       "VectorAgent", version, bundle_bytes)

    # -- batched action API --
    def request_for_actions(self, obs, masks=None, rewards=None):
        self._require_active()
        if self.host_mode == "anakin":
            raise RuntimeError(
                "anakin host: the env steps on-device inside rollout() — "
                "there is no per-step action request surface")
        return self.host.request_for_actions(obs, masks=masks,
                                             rewards=rewards)

    # -- fused rollout API (host_mode="anakin") --
    def rollout(self) -> dict:
        """One fused ``[num_envs, unroll_length]`` on-device window and its
        unstack into the N logical-agent trajectory streams (see
        :meth:`AnakinActorHost.rollout`)."""
        self._require_active()
        if self.host_mode != "anakin":
            raise RuntimeError(
                "rollout() is the anakin-host surface; this agent runs "
                f"host_mode={self.host_mode!r} (per-step request_for_actions)")
        return self.host.rollout()

    def flag_last_action(self, lane: int, reward: float = 0.0,
                         truncated: bool = False, final_obs=None,
                         terminated: bool | None = None,
                         final_mask=None) -> None:
        self._require_active()
        if self.host_mode == "anakin":
            raise RuntimeError(
                "anakin host: episode boundaries happen in the window "
                "(autoreset) — terminal markers are emitted by the window "
                "unstacker, not by the caller")
        self.host.flag_last_action(lane, reward, truncated=truncated,
                                   final_obs=final_obs,
                                   terminated=terminated,
                                   final_mask=final_mask)

    @property
    def model_version(self) -> int:
        return -1 if self.host is None else self.host.version

    def _require_active(self) -> None:
        if not self.active or self.host is None:
            raise RuntimeError(
                "vector agent is not active (call enable_agent())")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.disable_agent()


def run_gym_loop(agent: Agent, env, episodes: int, max_steps: int = 1000,
                 seed: int | None = None) -> list[float]:
    """The canonical loop: request_for_action → env.step →
    flag_last_action."""
    returns = []
    for ep in range(episodes):
        obs, _ = env.reset(seed=None if seed is None else seed + ep)
        ep_ret, reward = 0.0, 0.0
        terminated = truncated = False
        for _ in range(max_steps):
            record = agent.request_for_action(obs, reward=reward)
            obs, reward, terminated, truncated, _ = env.step(
                coerce_env_action(record.act))
            ep_ret += float(reward)
            if terminated or truncated:
                break
        # A time-limit ending ships the post-step obs so value targets
        # bootstrap through it; a genuine terminal takes precedence.
        time_limited = not terminated
        agent.flag_last_action(reward, truncated=time_limited,
                               final_obs=obs if time_limited else None)
        returns.append(ep_ret)
    return returns


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


def run_eval_loop(agent: Agent, env, episodes: int,
                  max_steps: int = 1000,
                  seed: int | None = None) -> list[float]:
    """Deterministic (greedy) evaluation episodes through a networked
    Agent — the policy is probed, not trained."""
    agent._require_active()
    return greedy_episodes(agent.actor, env, episodes, max_steps, seed)
