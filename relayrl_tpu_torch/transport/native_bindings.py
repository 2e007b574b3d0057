"""ctypes bindings for the native C++ transport core (native/transport.cc).

A copy of :mod:`relayrl_tpu.transport.native_bindings` over the port's
build of the library (:mod:`relayrl_tpu_torch._native`). Implements the
same :class:`ServerTransport`/:class:`AgentTransport` interfaces as the
ZMQ/gRPC backends over the framed-TCP protocol: one control connection
(handshake + trajectories) and one subscription connection (model
broadcasts) per agent, one epoll loop thread per server. The batch
drain hands the embedder the C++-decoded trajectories and the
columnar frames it parsed in Python as two calls, so the server can
count which decoder took each.
"""

from __future__ import annotations

import ctypes
import threading
import time

from relayrl_tpu_torch.transport.base import (
    AgentTransport,
    ServerTransport,
    swallow_decode_error,
    unpack_trajectory_envelope,
)
from relayrl_tpu_torch.transport.probe import parse_host_port as _parse_host_port

_EV_TRAJECTORY = 1
_EV_REGISTER = 2
_EV_UNREGISTER = 3


def _load(lib_path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(lib_path)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rl_server_create.restype = ctypes.c_void_p
    lib.rl_server_create.argtypes = [ctypes.c_char_p, ctypes.c_uint16]
    lib.rl_server_start.restype = ctypes.c_int
    lib.rl_server_start.argtypes = [ctypes.c_void_p]
    lib.rl_server_stop.argtypes = [ctypes.c_void_p]
    lib.rl_server_destroy.argtypes = [ctypes.c_void_p]
    lib.rl_server_port.restype = ctypes.c_uint16
    lib.rl_server_port.argtypes = [ctypes.c_void_p]
    lib.rl_server_set_model.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, u8p, ctypes.c_size_t]
    lib.rl_server_broadcast.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, u8p, ctypes.c_size_t]
    # Wire-v2 opaque-frame broadcast (no stored-model update). Tolerate a
    # stale prebuilt .so without the symbol: publishers then fall back to
    # full-bundle broadcasts (correctness kept, wire savings lost).
    try:
        lib.rl_server_broadcast_frame.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, u8p, ctypes.c_size_t]
    except AttributeError:
        pass
    lib.rl_server_poll.restype = ctypes.c_long
    lib.rl_server_poll.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int), u8p,
        ctypes.c_size_t]
    lib.rl_client_connect.restype = ctypes.c_void_p
    lib.rl_client_connect.argtypes = [ctypes.c_char_p, ctypes.c_uint16,
                                      ctypes.c_int]
    lib.rl_client_close.argtypes = [ctypes.c_void_p]
    lib.rl_client_get_model.restype = ctypes.c_long
    lib.rl_client_get_model.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint64), u8p,
        ctypes.c_size_t]
    lib.rl_client_register.restype = ctypes.c_int
    lib.rl_client_register.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_int]
    lib.rl_client_send_traj.restype = ctypes.c_int
    lib.rl_client_send_traj.argtypes = [ctypes.c_void_p, u8p, ctypes.c_size_t]
    lib.rl_client_ping.restype = ctypes.c_int
    lib.rl_client_ping.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rl_sub_ping.restype = ctypes.c_int
    lib.rl_sub_ping.argtypes = [ctypes.c_void_p]
    lib.rl_server_set_idle_timeout.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rl_sub_connect.restype = ctypes.c_void_p
    lib.rl_sub_connect.argtypes = [ctypes.c_char_p, ctypes.c_uint16,
                                   ctypes.c_int]
    lib.rl_sub_poll.restype = ctypes.c_long
    lib.rl_sub_poll.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint64), u8p,
        ctypes.c_size_t]
    lib.rl_server_poll_batch.restype = ctypes.c_long
    lib.rl_server_poll_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int)]
    lib.rl_sub_start_async.restype = ctypes.c_int
    lib.rl_sub_start_async.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rl_sub_next.restype = ctypes.c_long
    lib.rl_sub_next.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_int64), u8p, ctypes.c_size_t]
    lib.rl_sub_receipts.restype = ctypes.c_long
    lib.rl_sub_receipts.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_long]
    # native gRPC/HTTP-2 server (grpc_server.cc): same embedder surface
    lib.rl_grpc_server_create.restype = ctypes.c_void_p
    lib.rl_grpc_server_create.argtypes = [ctypes.c_char_p, ctypes.c_uint16]
    lib.rl_grpc_server_start.restype = ctypes.c_int
    lib.rl_grpc_server_start.argtypes = [ctypes.c_void_p]
    lib.rl_grpc_server_stop.argtypes = [ctypes.c_void_p]
    lib.rl_grpc_server_destroy.argtypes = [ctypes.c_void_p]
    lib.rl_grpc_server_port.restype = ctypes.c_uint16
    lib.rl_grpc_server_port.argtypes = [ctypes.c_void_p]
    lib.rl_grpc_server_set_model.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, u8p, ctypes.c_size_t]
    lib.rl_grpc_server_broadcast.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, u8p, ctypes.c_size_t]
    lib.rl_grpc_server_set_idle_timeout.argtypes = [ctypes.c_void_p,
                                                    ctypes.c_int]
    lib.rl_grpc_server_poll.restype = ctypes.c_long
    lib.rl_grpc_server_poll.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int), u8p,
        ctypes.c_size_t]
    lib.rl_grpc_server_poll_batch.restype = ctypes.c_long
    lib.rl_grpc_server_poll_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int)]
    return lib


def _buf(data: bytes):
    return (ctypes.c_uint8 * len(data)).from_buffer_copy(data) if data else None


class NativeServerTransportImpl(ServerTransport):
    PREFIX = "rl_server"  # symbol prefix: framed-TCP core (transport.cc)
    GAUGE_BACKEND = "native"  # relayrl_transport_subscribers label

    # The C++ core answers kFrameGetModel itself from set_model bytes, so
    # wire-v2 publishes must ride with a full v1 bundle for handshakes.
    needs_handshake_bytes = True

    def __init__(self, lib_path: str, bind_addr: str,
                 idle_timeout_s: float = 0.0, chunk_bytes: int = 0):
        super().__init__()
        self._lib = _load(lib_path)
        self._bind_addr = bind_addr  # subscriber-gauge instance label
        host, port = _parse_host_port(bind_addr)
        self._handle = self._fn("create")(host.encode(), port)
        if not self._handle:
            raise RuntimeError(f"native server bind failed on {bind_addr}")
        # 0 disables reaping; live agents heartbeat well inside any sane
        # timeout, so only crashed/partitioned peers are dropped.
        self._idle_timeout_ms = int(idle_timeout_s * 1000)
        # transport.chunk_bytes — the C++ framed protocol handles big
        # frames natively, so chunking defaults off here; when enabled
        # the chunks ride kFrameModelPush opaquely (pass-through) and the
        # Python sub loop reassembles. NB: each chunk stamps a C++
        # receipt, so fan-out accounting sees per-chunk receipt rows.
        self._chunk_bytes = max(0, int(chunk_bytes))
        self._poller: threading.Thread | None = None
        self._stop = threading.Event()
        self.drain_parse_failures = 0  # lost decoded batches (observable)
        # Registered-agent table for the relayrl_transport_subscribers
        # pull-gauge — the Python mirror of the C++ registry events
        # (register/unregister), maintained in the poll loops before the
        # embedder callbacks fire. Counts LOGICAL agents: the C++ core
        # does not expose its kernel connection table, so vector hosts
        # read as N lanes here (documented in docs/observability.md).
        self._subscriber_table: set[str] = set()
        self._subscriber_lock = threading.Lock()

    def _fn(self, name):
        return getattr(self._lib, f"{self.PREFIX}_{name}")

    def _note_subscriber(self, agent_id: str, alive: bool) -> None:
        with self._subscriber_lock:
            if alive:
                self._subscriber_table.add(agent_id)
            else:
                self._subscriber_table.discard(agent_id)

    def _subscriber_count(self) -> int:
        with self._subscriber_lock:
            return len(self._subscriber_table)

    @property
    def port(self) -> int:
        return int(self._fn("port")(self._handle))

    def start(self) -> None:
        if self._fn("start")(self._handle) != 0:
            raise RuntimeError("native server start failed")
        if self._idle_timeout_ms > 0:
            self._fn("set_idle_timeout")(self._handle,
                                                 self._idle_timeout_ms)
        version, bundle = self.get_model()
        data = _buf(bundle)
        self._fn("set_model")(self._handle, version, data,
                                      len(bundle))
        from relayrl_tpu_torch.transport.base import register_subscriber_gauge

        register_subscriber_gauge(self.GAUGE_BACKEND, self._subscriber_count,
                                  bind=self._bind_addr)
        self._stop.clear()
        self._poller = threading.Thread(target=self._poll_loop,
                                        name="native-server-poll", daemon=True)
        self._poller.start()

    def stop(self) -> None:
        self._stop.set()
        if self._poller is not None:
            self._poller.join(timeout=5)
            self._poller = None
        self._fn("stop")(self._handle)

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._fn("destroy")(self._handle)
                self._handle = None
        except Exception:
            pass

    def publish_model(self, version: int, bundle_bytes: bytes,
                      handshake_bytes: bytes | None = None) -> None:
        """Legacy (v1) publishes broadcast AND store ``bundle_bytes`` as
        the handshake model in one C++ call. Wire-v2 publishes pass the
        frame as ``bundle_bytes`` plus a full v1 bundle as
        ``handshake_bytes``: the bundle goes to set_model (handshakes),
        the frame rides broadcast_frame opaquely (chunked when
        ``transport.chunk_bytes`` bounds it)."""
        if handshake_bytes is None:
            data = _buf(bundle_bytes)
            self._fn("broadcast")(self._handle, version, data,
                                  len(bundle_bytes))
            return
        hs = _buf(handshake_bytes)
        self._fn("set_model")(self._handle, version, hs, len(handshake_bytes))
        if not hasattr(self._lib, "rl_server_broadcast_frame"):
            # Stale prebuilt .so: broadcast the full bundle instead (the
            # C++ broadcast would otherwise store the frame as the
            # handshake model and poison late joiners).
            data = _buf(handshake_bytes)
            self._fn("broadcast")(self._handle, version, data,
                                  len(handshake_bytes))
            return
        from relayrl_tpu_torch.transport.modelwire import split_frame

        for part in split_frame(bundle_bytes, self._chunk_bytes, version):
            data = _buf(part)
            self._lib.rl_server_broadcast_frame(self._handle, version, data,
                                                len(part))

    def _poll_loop(self) -> None:
        # Two modes, picked at start() by whether the embedder wants the
        # columnar fast path:
        #  * batch drain (TrainingServer): rl_server_poll_batch decodes
        #    whole batches of trajectory envelopes in C++ (GIL released)
        #    and this thread just parses RLD1 headers — one Python
        #    callback per trajectory carrying ready numpy columns.
        #  * legacy per-event: raw envelope bytes through on_trajectory,
        #    byte-compatible for embedders without a decoded handler.
        if self.on_trajectory_decoded is not None:
            self._poll_loop_batch()
        else:
            self._poll_loop_raw()

    def _poll_loop_batch(self) -> None:
        from relayrl_tpu_torch.types.columnar import (
            DecodedTrajectory,
            Registration,
            RawTrajectory,
            Unregistration,
            is_columnar_frame,
            parse_drain,
            parse_frame,
        )

        from relayrl_tpu_torch import telemetry

        reg = telemetry.get_registry()
        m_frames = reg.counter(
            "relayrl_server_columnar_frames_total",
            "columnar trajectory frames decoded straight into "
            "DecodedTrajectory (the wire fast path)")
        m_frame_bytes = reg.counter(
            "relayrl_server_columnar_bytes_total",
            "columnar trajectory frame bytes decoded")
        m_frame_rejects = reg.counter(
            "relayrl_server_columnar_rejects_total",
            "columnar frames refused at decode (CRC mismatch / "
            "malformed layout) — also counted in dropped_total")
        cap = 1 << 20
        buf = (ctypes.c_uint8 * cap)()
        n_items = ctypes.c_int(0)
        while not self._stop.is_set():
            n = self._fn("poll_batch")(
                self._handle, 100, 256, buf, cap, ctypes.byref(n_items))
            if n < 0:
                continue
            if n_items.value == 0:  # first blob alone exceeds cap: grow
                cap = max(int(n) * 2, cap * 2)
                buf = (ctypes.c_uint8 * cap)()
                continue
            try:
                items = parse_drain(ctypes.string_at(buf, int(n)))
            except Exception as e:
                # A C++/Python RLD1 layout disagreement loses the whole
                # already-dequeued batch — make that observable, never
                # silent (and never crash ingest).
                self.drain_parse_failures += 1
                print(f"[NativeTransport] drain buffer unparseable "
                      f"({e!r}) — a decoded batch was LOST "
                      f"(#{self.drain_parse_failures})", flush=True)
                continue
            # One decoded-batch callback per drain (not per trajectory):
            # at fleet rate the per-item queue handoff was measurable.
            # Columnar wire frames parsed here go in a second call.
            batch, frames = [], []
            for item in items:
                if isinstance(item, DecodedTrajectory):
                    batch.append(item)
                elif isinstance(item, RawTrajectory):
                    agent_id, payload = item.agent_id, item.payload
                    if item.is_envelope:
                        try:
                            agent_id, payload = unpack_trajectory_envelope(
                                payload)
                        except Exception as e:
                            # truly malformed; Python decode will drop —
                            # but count it, and re-raise non-data errors
                            swallow_decode_error("native",
                                                 "trajectory_ingest", e)
                    if is_columnar_frame(payload):
                        # Columnar wire frame: the C++ envelope decoder
                        # carried it through verbatim (raw fallback, id
                        # intact incl. any seq tag); parse it here and
                        # join the decoded batch — same funnel as the
                        # C++-decoded items (seq dedup + guardrails in
                        # _on_trajectory_decoded).
                        try:
                            frames.append(parse_frame(payload,
                                                      agent_id=agent_id))
                            m_frames.inc()
                            m_frame_bytes.inc(len(payload))
                        except Exception as e:
                            # Same operator surface as the zmq/grpc
                            # staging path: a refused frame is visible
                            # on every transport.
                            m_frame_rejects.inc()
                            swallow_decode_error("native",
                                                 "columnar_frame", e)
                        continue
                    self.on_trajectory(agent_id, payload)
                elif isinstance(item, Registration):
                    self._note_subscriber(item.agent_id, True)
                    self.on_register(item.agent_id)
                elif isinstance(item, Unregistration):
                    self._note_subscriber(item.agent_id, False)
                    self.on_unregister(item.agent_id)
            if batch:
                self.on_trajectory_decoded(batch)
            if frames:
                self.on_trajectory_decoded(frames, codec="columnar")

    def _poll_loop_raw(self) -> None:
        # One long-lived buffer, grown on demand: allocating a fresh
        # ctypes array per event zeroes the whole capacity each time and
        # dominated the ingest path (~5x at 64-actor scale).
        cap = 1 << 20
        buf = (ctypes.c_uint8 * cap)()
        ev_type = ctypes.c_int(0)
        while not self._stop.is_set():
            n = self._fn("poll")(self._handle, 100,
                                         ctypes.byref(ev_type), buf, cap)
            if n < 0:
                continue
            if n > cap:  # grow and re-take (event was held back)
                cap = int(n) * 2
                buf = (ctypes.c_uint8 * cap)()
                continue
            payload = ctypes.string_at(buf, int(n))
            if ev_type.value == _EV_TRAJECTORY:
                try:
                    agent_id, traj = unpack_trajectory_envelope(payload)
                except Exception as e:
                    swallow_decode_error("native", "trajectory_ingest", e)
                    continue
                self.on_trajectory(agent_id, traj)
            elif ev_type.value == _EV_REGISTER:
                agent_id = payload.decode(errors="replace")
                self._note_subscriber(agent_id, True)
                self.on_register(agent_id)
            elif ev_type.value == _EV_UNREGISTER:
                agent_id = payload.decode(errors="replace")
                self._note_subscriber(agent_id, False)
                self.on_unregister(agent_id)


class NativeAgentTransportImpl(AgentTransport):
    # Liveness gauge encoding (docs/observability.md): the ping() rc
    # space folded to three operator states.
    _HB_ALIVE, _HB_SLOW, _HB_DEAD = 0, 1, 2

    def __init__(self, lib_path: str, server_addr: str,
                 identity: str | None = None, heartbeat_s: float = 5.0,
                 retry: dict | None = None):
        super().__init__()
        import os
        import secrets

        from relayrl_tpu_torch import faults
        from relayrl_tpu_torch.transport.base import agent_wire_metrics
        from relayrl_tpu_torch.transport.retry import RetryPolicy

        self._retry = RetryPolicy.from_dict(retry)
        self._fault_send = faults.site("agent.send")
        self._fault_model = faults.site("agent.model")
        self._lib = _load(lib_path)
        self.identity = identity or f"AGENT_ID-{os.getpid()}{secrets.token_hex(4)}"
        self._host, self._port = _parse_host_port(server_addr)
        self._ctrl = None
        self._had_ctrl = False  # distinguishes first connect from redial
        # Serializes every C call on the ctrl handle against the
        # fault-plane _kill_ctrl close: without it, a kill_connection
        # injection could free the handle mid-ping/send on another
        # thread (use-after-free in the C library, a REAL crash the
        # drill did not intend). Ping holds it <= its 1s timeout.
        self._ctrl_lock = threading.Lock()
        self._sub = None
        # transport.heartbeat_s config knob (was a hard-coded 5.0 in
        # start_model_listener); <= 0 disables the beat entirely.
        self._heartbeat_default = float(heartbeat_s)
        self._heartbeat_s = 0.0
        self._hb_state = self._HB_ALIVE
        self._listener: threading.Thread | None = None
        self._stop = threading.Event()
        self._m = agent_wire_metrics("native")
        from relayrl_tpu_torch import telemetry

        self._m_liveness = telemetry.get_registry().gauge(
            "relayrl_transport_heartbeat_state",
            "control-channel liveness: 0=alive, 1=slow, 2=dead",
            {"backend": "native"})

    def _ensure_ctrl(self, timeout_s: float):
        """Control-channel connect under the unified RetryPolicy (was a
        flat 0.2s sleep loop — the third per-backend retry dialect this
        policy replaces)."""
        if self._ctrl is None:
            def attempt():
                handle = self._lib.rl_client_connect(
                    self._host.encode(), self._port, 2000)
                return handle or None

            try:
                self._ctrl = self._retry.call(attempt, op="native.connect",
                                              deadline_s=timeout_s)
            except TimeoutError:
                raise TimeoutError(
                    f"native transport: cannot connect to "
                    f"{self._host}:{self._port}") from None
            if self._had_ctrl:
                # A REDIAL, not the first connect: the server reaped the
                # old connection's registrations on kernel close — the
                # owner must re-register its lanes and replay the spool.
                self._notify_reconnect()
            self._had_ctrl = True
        return self._ctrl

    def fetch_model(self, timeout_s: float = 60.0) -> tuple[int, bytes]:
        ctrl = self._ensure_ctrl(timeout_s)
        cap = 1 << 20
        deadline = time.monotonic() + timeout_s
        version = ctypes.c_uint64(0)
        while True:
            remaining = max(100, int((deadline - time.monotonic()) * 1000))
            buf = (ctypes.c_uint8 * cap)()
            with self._ctrl_lock:
                n = self._lib.rl_client_get_model(
                    ctrl, min(remaining, 5000), ctypes.byref(version),
                    buf, cap)
            if 0 <= n <= cap:
                return int(version.value), bytes(buf[: int(n)])
            if n > cap:
                cap = int(n) * 2
                continue
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    "native model handshake timed out — check the server is "
                    "up AND that both ends use the same server_type (a zmq/"
                    "grpc server will silently ignore native framing)")

    def register(self, agent_id: str | None = None, timeout_s: float = 10.0) -> bool:
        ctrl = self._ensure_ctrl(timeout_s)
        with self._ctrl_lock:
            rc = self._lib.rl_client_register(
                ctrl, (agent_id or self.identity).encode(),
                int(timeout_s * 1000))
        return rc == 0

    def send_trajectory(self, payload: bytes,
                        agent_id: str | None = None) -> None:
        from relayrl_tpu_torch.transport.base import pack_trajectory_envelope

        env = pack_trajectory_envelope(agent_id or self.identity, payload)
        if self._fault_send is not None:
            if self._fault_send.take_kill_connection():
                self._kill_ctrl()
            parts = self._fault_send.inject(env)
            if not parts:
                # ack'd transport: a lost frame surfaces as a failed
                # send — raise so the spool buffers and replays it.
                raise RuntimeError("fault-injected trajectory drop (native)")
        else:
            parts = ((0.0, env),)
        ctrl = self._ensure_ctrl(5.0)
        t0 = time.monotonic()
        for delay_s, part in parts:
            if delay_s > 0:
                time.sleep(delay_s)
            data = _buf(part)
            with self._ctrl_lock:
                if self._ctrl is not ctrl:  # killed mid-batch: redial
                    raise RuntimeError(
                        "native trajectory send failed (connection "
                        "killed mid-send)")
                rc = self._lib.rl_client_send_traj(ctrl, data, len(part))
            if rc != 0:
                raise RuntimeError("native trajectory send failed")
            self._m["send_total"].inc()
            self._m["send_bytes"].inc(len(part))
        self._m["send_seconds"].observe(time.monotonic() - t0)

    def _kill_ctrl(self) -> None:
        """Fault-plane connection kill: drop the control channel the way
        a crash would; the next send redials through _ensure_ctrl (and
        the server's kernel-close reaping unregisters this agent). The
        close happens under _ctrl_lock so no other thread can be inside
        a C call on the handle being freed."""
        with self._ctrl_lock:
            ctrl, self._ctrl = self._ctrl, None
            if ctrl:
                self._lib.rl_client_close(ctrl)

    def ping(self, timeout_s: float = 2.0) -> int:
        """Liveness probe on the control channel: 0 alive, 2 slow (no pong
        inside the timeout, connection kept), 1 hard failure healed by
        redial, -1 dead even after redial."""
        ctrl = self._ensure_ctrl(timeout_s)
        with self._ctrl_lock:
            return int(self._lib.rl_client_ping(ctrl,
                                                int(timeout_s * 1000)))

    def start_model_listener(self, heartbeat_s: float | None = None) -> None:
        """``heartbeat_s=None`` uses the constructor's value (the
        ``transport.heartbeat_s`` config knob); an explicit argument
        still overrides per-listener."""
        if self._listener is not None:
            return
        self._sub = self._lib.rl_sub_connect(self._host.encode(), self._port,
                                             5000)
        if not self._sub:
            raise RuntimeError("native subscribe connection failed")
        self._heartbeat_s = (self._heartbeat_default if heartbeat_s is None
                             else float(heartbeat_s))
        # Async mode: a C++ reader thread owns the socket — it parses and
        # CLOCK_MONOTONIC-timestamps every ModelPush the moment it arrives
        # (GIL-free; the receipt ledger is the soak benches' fan-out
        # evidence), owns the sub-channel keepalive, and reconnects. The
        # Python thread below only drains the decoded queue.
        self._lib.rl_sub_start_async(self._sub, int(self._heartbeat_s * 1000))
        self._stop.clear()
        self._listener = threading.Thread(target=self._sub_loop,
                                          name="native-model-sub", daemon=True)
        self._listener.start()

    def drain_receipts(self, max_n: int = 65536) -> list[tuple[int, int]]:
        """Drain the C++ receipt ledger: ``[(version, rx_mono_ns), ...]``,
        stamped at frame parse in the native reader thread — comparable
        against ``time.monotonic_ns()`` of any process on this host."""
        if self._sub is None:
            return []
        vers = (ctypes.c_uint64 * max_n)()
        ts = (ctypes.c_int64 * max_n)()
        n = self._lib.rl_sub_receipts(self._sub, vers, ts, max_n)
        return [(int(vers[i]), int(ts[i])) for i in range(int(n))]

    def _sub_loop(self) -> None:
        from relayrl_tpu_torch.transport.modelwire import ChunkReassembler

        cap = 1 << 20
        buf = (ctypes.c_uint8 * cap)()  # reused; fresh alloc zeroes 1 MiB/poll
        version = ctypes.c_uint64(0)
        rx_ns = ctypes.c_int64(0)
        last_beat = time.monotonic()
        # Chunked wire-v2 frames (server transport.chunk_bytes) ride the
        # C++ core as opaque ModelPush payloads; reassemble before
        # on_model so the embedder always sees whole frames.
        reasm = ChunkReassembler()
        while not self._stop.is_set():
            n = self._lib.rl_sub_next(self._sub, 200, ctypes.byref(version),
                                      ctypes.byref(rx_ns), buf, cap)
            # Control-channel ping still detects a dead server (and redials
            # C++-side) even when the agent is neither stepping nor
            # receiving models; the sub channel's keepalive now lives in
            # the C++ async reader.
            if (self._heartbeat_s > 0
                    and time.monotonic() - last_beat >= self._heartbeat_s):
                last_beat = time.monotonic()
                with self._ctrl_lock:
                    ctrl = self._ctrl
                    rc = (int(self._lib.rl_client_ping(ctrl, 1000))
                          if ctrl else None)
                if rc is not None:
                    # rc: 0 alive, 2 slow (no pong in window), 1 hard
                    # failure healed by redial (counts as a reconnect,
                    # lands alive, and fires on_reconnect so the owner
                    # re-registers + replays its spool), -1 dead even
                    # after redial.
                    if rc == 1:
                        self._notify_reconnect()
                    state = (self._HB_ALIVE if rc in (0, 1)
                             else self._HB_SLOW if rc == 2
                             else self._HB_DEAD)
                    self._m_liveness.set(state)
                    # Journal the TRANSITION only (the gauge carries the
                    # level; one event per ping would swamp the journal).
                    if state != self._hb_state:
                        from relayrl_tpu_torch import telemetry

                        telemetry.emit(
                            "heartbeat",
                            state=("alive", "slow", "dead")[state],
                            prev=("alive", "slow", "dead")[self._hb_state])
                        self._hb_state = state
            if n < 0:
                continue
            if n > cap:
                cap = int(n) * 2
                buf = (ctypes.c_uint8 * cap)()
                continue
            # rx_ns is the C++ reader's frame-parse stamp (the ledger
            # truth); deliver_seconds measures the Python-side handoff
            # from there through the swap.
            self._m["model_recv_bytes"].inc(int(n))
            blob = reasm.feed(ctypes.string_at(buf, int(n)))
            if blob is None:
                continue  # mid-chunk: deliver on the final part
            self._m["model_recv_total"].inc()
            if self._fault_model is not None:
                # chaos plane: the C++ ledger already stamped the
                # receipt; the injected fault hits the delivery layer —
                # corrupt dies in the actor's decode/CRC guards, drop
                # waits out the keyframe cadence.
                for delay_s, part in self._fault_model.inject(blob):
                    if delay_s > 0:
                        time.sleep(delay_s)
                    self.on_model(int(version.value), part)
            else:
                self.on_model(int(version.value), blob)
            self._m["model_deliver_seconds"].observe(
                max(0.0, (time.monotonic_ns() - int(rx_ns.value)) / 1e9))
            # Downstream trace receipt hop off the C++ ledger's stamp.
            from relayrl_tpu_torch.telemetry.trace import (
                record_model_receipt,
            )

            record_model_receipt(int(version.value), int(rx_ns.value),
                                 None, "native")

    def close(self, drain_s: float = 0.0) -> None:
        # Sends are acked before they return: nothing is left to drain.
        self._stop.set()
        if self._listener is not None:
            self._listener.join(timeout=5)
            self._listener = None
        for handle in (self._ctrl, self._sub):
            if handle:
                self._lib.rl_client_close(handle)
        self._ctrl = self._sub = None


class NativeGrpcServerTransportImpl(NativeServerTransportImpl):
    """The native gRPC plane (native/grpc_server.cc): a hand-written
    HTTP/2 server speaking the exact gRPC wire protocol of the Python
    backend's two RPCs (SendActions, ClientPoll long-poll), with the same
    embedder surface as the framed core — EventHub batch drain, columnar
    decode, model broadcast waking parked polls. grpcio agents connect to
    it unchanged.

    ``idle_timeout_s`` here is the ClientPoll long-poll window (the
    Python backend's semantic), not connection reaping.
    """

    PREFIX = "rl_grpc_server"
    GAUGE_BACKEND = "grpc"  # relayrl_transport_subscribers label

    # The C++ ClientPoll serves the stored model to every subscriber and
    # cannot pick delta-vs-full per known version: wire-v2 frames would
    # be encoded, paid for, and then discarded. The embedding server
    # reads this and skips the encoder entirely on this plane.
    serves_full_bundles_only = True

    def __init__(self, lib_path: str, bind_addr: str,
                 idle_timeout_s: float = 30.0):
        super().__init__(lib_path, bind_addr, idle_timeout_s=idle_timeout_s)

    @property
    def idle_timeout_s(self) -> float:
        return self._idle_timeout_ms / 1000.0

    @idle_timeout_s.setter
    def idle_timeout_s(self, value: float) -> None:
        # tests/embedders tune the long-poll window after construction
        self._idle_timeout_ms = int(value * 1000)
        self._fn("set_idle_timeout")(self._handle, self._idle_timeout_ms)

    def publish_model(self, version: int, bundle_bytes: bytes,
                      handshake_bytes: bytes | None = None) -> None:
        """The native gRPC plane serves ClientPoll long-polls from the
        C++ stored model, which cannot pick delta-vs-full per subscriber
        — so this plane stays full-bundle: a wire-v2 publish stores and
        wakes pollers with the v1 ``handshake_bytes`` (agents decode it
        through the same sniffing path)."""
        blob = handshake_bytes if handshake_bytes is not None else bundle_bytes
        data = _buf(blob)
        self._fn("broadcast")(self._handle, version, data, len(blob))
