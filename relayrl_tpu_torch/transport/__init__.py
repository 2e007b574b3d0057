"""Transport plane: the ZMQ and gRPC backends.

Counterpart of :mod:`relayrl_tpu.transport`. ``make_server_transport`` /
``make_agent_transport`` resolve a backend by name as the JAX package
does, and speak its wire byte for byte, so a port agent feeds a JAX
server and a JAX agent feeds a port server. ZMQ and the pure-grpcio gRPC
backend are ported; ``server_type="native"`` raises
:class:`NotImplementedError` (``ROADMAP.md`` queue 1 item 4: it needs
``native/``'s C++ library, which the port does not load) and never falls
back. ``"auto"`` resolves to ZMQ on both sides (the JAX package's
``auto`` prefers native when its library loads).
"""

from __future__ import annotations

from relayrl_tpu_torch.config import ConfigLoader
from relayrl_tpu_torch.transport.base import (
    AgentTransport,
    ServerTransport,
    pack_model_frame,
    pack_trajectory_envelope,
    unpack_model_frame,
    unpack_trajectory_envelope,
)
from relayrl_tpu_torch.transport.probe import (
    ProtocolMismatchError,
    parse_host_port,
    probe_endpoint,
)

_KNOWN_TYPES = ("zmq", "grpc", "native")


def _resolve(server_type: str | None) -> str:
    """Validate ``server_type`` and map it onto a ported backend."""
    server_type = (server_type or "zmq").lower()
    if server_type == "auto":
        return "zmq"
    if server_type not in _KNOWN_TYPES:
        raise ValueError(
            f"unknown server_type {server_type!r} (zmq|grpc|native|auto)")
    if server_type == "native":
        raise NotImplementedError(
            "server_type='native' is not ported (ROADMAP.md queue 1 item "
            "4: it needs native/'s C++ library, which the port does not "
            "load); use server_type='zmq' or 'grpc'")
    return server_type


def _agent_handshake_addr(server_type: str, config: ConfigLoader,
                          overrides: dict) -> str:
    """Each backend's agent-side handshake address — used both by the
    pre-flight probe and by the constructors below, so the probe never
    verifies an address the transport doesn't connect to."""
    if server_type == "zmq":
        return overrides.get("agent_listener_addr",
                             config.get_agent_listener().address)
    return overrides.get("server_addr", config.get_train_server().host_port)


def _verify_agent_protocol(server_type: str, config: ConfigLoader,
                           overrides: dict) -> None:
    """Fail fast when the server at the configured endpoint demonstrably
    speaks a different protocol (instead of a silent handshake timeout)."""
    host, port = parse_host_port(
        _agent_handshake_addr(server_type, config, overrides))
    verdict = probe_endpoint(host, port, timeout_s=0.75)
    if verdict in ("zmq", "native", "grpc") and verdict != server_type:
        raise ProtocolMismatchError(
            f"server at {host}:{port} speaks {verdict!r} but this agent is "
            f"configured with server_type={server_type!r} — fix server_type "
            f"on one end")


def make_server_transport(server_type: str, config: ConfigLoader,
                          **overrides) -> ServerTransport:
    server_type = _resolve(server_type)
    transport_params = config.get_transport_params()
    chunk_bytes = overrides.get("chunk_bytes",
                                transport_params["chunk_bytes"])
    if int(transport_params.get("wire_version", 2)) < 2:
        # wire_version=1 serves pre-v2 actors, which cannot reassemble
        # chunk frames.
        chunk_bytes = 0
    if server_type == "grpc":
        from relayrl_tpu_torch.transport.grpc_backend import (
            GrpcServerTransport,
        )

        return GrpcServerTransport(
            bind_addr=overrides.get("bind_addr",
                                    config.get_train_server().host_port),
            idle_timeout_s=config.get_grpc_idle_timeout_s())
    from relayrl_tpu_torch.transport.zmq_backend import ZmqServerTransport

    return ZmqServerTransport(
        agent_listener_addr=overrides.get(
            "agent_listener_addr", config.get_agent_listener().address),
        trajectory_addr=overrides.get(
            "trajectory_addr", config.get_traj_server().address),
        model_pub_addr=overrides.get(
            "model_pub_addr", config.get_train_server().address),
        chunk_bytes=chunk_bytes,
    )


def make_agent_transport(server_type: str, config: ConfigLoader,
                         **overrides) -> AgentTransport:
    """Build an agent transport. An explicit type is verified with a quick
    probe so a mismatched fleet errors at construction
    (:class:`ProtocolMismatchError`) rather than timing out on
    ``fetch_model``. Pass ``probe=False`` to skip the pre-flight check."""
    requested = (server_type or "zmq").lower()
    server_type = _resolve(requested)
    should_probe = overrides.pop("probe", True)
    overrides.pop("negotiate_window_s", None)
    if should_probe and requested != "auto":
        _verify_agent_protocol(server_type, config, overrides)
    retry_cfg = overrides.get("retry", config.get_transport_params()["retry"])
    if server_type == "grpc":
        from relayrl_tpu_torch.transport.grpc_backend import (
            GrpcAgentTransport,
        )

        return GrpcAgentTransport(
            server_addr=_agent_handshake_addr("grpc", config, overrides),
            identity=overrides.get("identity"),
            poll_timeout_s=config.get_grpc_idle_timeout_s() + 5.0,
            retry=retry_cfg,
        )
    from relayrl_tpu_torch.transport.zmq_backend import ZmqAgentTransport

    return ZmqAgentTransport(
        agent_listener_addr=_agent_handshake_addr("zmq", config, overrides),
        trajectory_addr=overrides.get(
            "trajectory_addr", config.get_traj_server().address),
        model_sub_addr=overrides.get(
            "model_sub_addr", config.get_train_server().address),
        identity=overrides.get("identity"),
        retry=retry_cfg,
    )


__all__ = [
    "ServerTransport",
    "AgentTransport",
    "ProtocolMismatchError",
    "probe_endpoint",
    "make_server_transport",
    "make_agent_transport",
    "pack_model_frame",
    "unpack_model_frame",
    "pack_trajectory_envelope",
    "unpack_trajectory_envelope",
]
