"""gRPC transport backend.

Capability parity with the reference's tonic service
(reference: relayrl_framework/proto/relayrl_grpc.proto:33-36 — service
``RelayRLRoute { SendActions, ClientPoll }``; server impl
src/network/server/training_grpc.rs:565-798; client
src/network/client/agent_grpc.rs). The two-RPC surface is kept:

* ``SendActions``  — trajectory envelope in, ack out (train is async,
  matching training_grpc.rs:637-641's immediate reply).
* ``ClientPoll``   — ``{agent_id, version, first_time}`` in; blocks until a
  model newer than ``version`` exists or the idle timeout lapses, then
  returns the bundle (long-poll replacing the reference's watch channel,
  training_grpc.rs:731-796 — with the timeout honored in *seconds*, fixing
  the seconds-as-millis bug at :757).

Implementation note: handlers are registered dynamically via
``grpc.method_handlers_generic_handler`` with msgpack bodies — the wire
contract is this module, not a compiled proto, so the native C++ backend and
any future proto can interoperate by speaking the same envelopes.

Departure: the reference agent calls ``process::exit(1)`` on a failed
trajectory send (agent_grpc.rs:529-531); here send errors raise to the
caller.

A copy of :mod:`relayrl_tpu.transport.grpc_backend` with ``grpc`` and
``msgpack`` imported inside the functions that use them, so importing the
port loads neither. A ``TrainingServer`` with ``serving.enabled``
installs its ``InferenceService`` as ``on_infer`` (``GetActions``, one
parked RPC thread per request) and ``on_infer_submit``
(``StreamActions``); without it both answer with the typed "serving is
not enabled" nack, byte for byte the JAX server's answer.
"""

from __future__ import annotations

import threading
import time

from relayrl_tpu_torch.transport.base import (
    NACK_OVERLOADED,
    NACK_QUARANTINED,
    AgentTransport,
    IngestNack,
    ReceiptLedger,
    ServerTransport,
    agent_wire_metrics,
    server_wire_metrics,
    swallow_decode_error,
    unpack_trajectory_envelope,
)
from relayrl_tpu_torch.transport.retry import RetryPolicy

_SERVICE = "relayrl.RelayRLRoute"


def _identity(x: bytes) -> bytes:
    return x


def _pack_infer_nack(req_id: int, code: int, reason: str,
                     retry_after_s: float = 0.0) -> bytes:
    """The serving plane's typed nack reply (``relayrl_tpu.transport.
    serving.pack_infer_nack``'s bytes)."""
    import msgpack

    return msgpack.packb({"req": int(req_id), "code": int(code),
                          "error": str(reason),
                          "retry_after_s": float(retry_after_s)},
                         use_bin_type=True)


class _Servicer:
    def __init__(self, owner: "GrpcServerTransport"):
        self._owner = owner

    def send_actions(self, request: bytes, context) -> bytes:
        import msgpack

        self._owner._m["recv_total"].inc()
        self._owner._m["recv_bytes"].inc(len(request))
        try:
            agent_id, payload = unpack_trajectory_envelope(request)
        except Exception as e:
            # data-shaped decode errors drop with a counter; programming
            # errors re-raise (grpc surfaces them to the caller as an
            # RPC error instead of a silent code-0 ack).
            swallow_decode_error("grpc", "trajectory_ingest", e)
            return msgpack.packb({"code": 0, "error": "malformed envelope"})
        verdict = None
        if self._owner.check_ingest is not None:
            # Guardrail admission (quarantine / overload-nack): this
            # plane HAS a back-channel, so a refused send is a typed
            # nack the sender's spool can act on instead of a silent
            # server-side shed (transport/base.py NACK_* codes).
            verdict = self._owner.check_ingest(agent_id)
        if verdict is not None:
            code, reason, retry_after = verdict
            return msgpack.packb({"code": int(code), "error": str(reason),
                                  "retry_after_s": float(retry_after)})
        self._owner.on_trajectory(agent_id, payload)
        return msgpack.packb({"code": 1})

    def _model_update(self, known_version: int) -> tuple[int, bytes]:
        """The freshest blob a subscriber holding ``known_version`` can
        decode: the model-wire v2 delta/keyframe frame when the embedder
        installed ``get_model_update`` (the delta-vs-full choice is
        per-subscriber on this pull plane), else the full bundle."""
        fn = self._owner.get_model_update
        if fn is not None:
            return fn(known_version)
        return self._owner.get_model()

    def _model_version(self) -> int:
        """Version probe for long-poll wakeups — must not force a full
        bundle serialize (wire-v2 servers serialize v1 bytes lazily)."""
        fn = self._owner.get_model_version
        if fn is not None:
            return int(fn())
        return self._owner.get_model()[0]

    def get_actions(self, request: bytes, context) -> bytes:
        """Serving-plane RPC (disaggregated batched inference): hand the
        observation request to the embedder's InferenceService and block
        this RPC thread until its batch executes. Without a service
        installed the reply is a pointed error, not a hang.

        Parked inference RPCs share the worker pool with SendActions and
        the ClientPoll long-polls, so their CONCURRENCY is capped at half
        the pool (``_infer_slots``): beyond it, arrivals get an immediate
        typed overload nack — an inference flood must degrade to client
        backoff, never to fleet-wide ingest starvation."""
        from relayrl_tpu_torch.transport.base import (
            NACK_OVERLOADED,
            NACK_UNAVAILABLE,
        )
        if self._owner.on_infer is None:
            return _pack_infer_nack(
                -1, NACK_UNAVAILABLE,
                "inference serving is not enabled on this server "
                "(set serving.enabled: true)")
        if not self._owner._infer_slots.acquire(blocking=False):
            return _pack_infer_nack(
                -1, NACK_OVERLOADED,
                "inference RPC slots exhausted (serving shares the RPC "
                "pool with ingest)", 0.05)
        try:
            return self._owner.on_infer(request)
        finally:
            self._owner._infer_slots.release()

    def stream_actions(self, request_iterator, context):
        """Bidi serving stream (serving v2): every inbound frame is a
        pipelined inference request handed to the embedder's
        non-blocking submit hook; replies flow back on THIS stream in
        whatever order their batches execute (req-id matched client
        side). One stream parks ONE RPC thread regardless of its
        in-flight depth — the pipelining reason to prefer it over N
        parked GetActions unary calls — so it is not gated by the
        ``_infer_slots`` semaphore; the InferenceService's own
        ``queue_limit`` overload nacks are the backpressure."""
        import queue as queue_mod

        from relayrl_tpu_torch.transport.base import NACK_UNAVAILABLE

        submit = self._owner.on_infer_submit
        if submit is None:
            yield _pack_infer_nack(
                -1, NACK_UNAVAILABLE,
                "inference serving is not enabled on this server "
                "(set serving.enabled: true)")
            return
        out: "queue_mod.Queue[bytes | None]" = queue_mod.Queue()
        state = {"inflight": 0, "drained": False}
        lock = threading.Lock()

        def reply(b: bytes) -> None:
            # Runs on batch-worker (or pump) threads: deliver, then
            # close the stream once the client half-closed AND the last
            # in-flight reply is out.
            with lock:
                state["inflight"] -= 1
                last = state["drained"] and state["inflight"] == 0
            out.put(b)
            if last:
                out.put(None)

        def pump() -> None:
            try:
                for payload in request_iterator:
                    with lock:
                        state["inflight"] += 1
                    submit(payload, reply)
            except Exception:
                pass  # cancelled/broken stream: drain and fall through
            finally:
                with lock:
                    state["drained"] = True
                    empty = state["inflight"] == 0
                if empty:
                    out.put(None)

        threading.Thread(target=pump, name="grpc-serving-stream-pump",
                         daemon=True).start()
        while True:
            item = out.get()
            if item is None:
                return
            yield item

    def client_poll(self, request: bytes, context) -> bytes:
        import msgpack

        req = msgpack.unpackb(request, raw=False)
        agent_id = str(req.get("id", "?"))
        known_version = int(req.get("ver", -1))
        first_time = bool(req.get("first", False))
        self._owner._note_subscriber(agent_id)
        if first_time:
            self._owner.on_register(agent_id)
        # Version probe only on entry: get_model() would force the
        # wire-v2 server's LAZY v1 serialize for every published version
        # (under its bundle lock, on an RPC thread) even when the reply
        # ships a delta frame — the bundle is fetched only on the
        # branches that actually send it.
        version = self._model_version()
        if first_time and version <= known_version:
            # Logical-lane registration (vector hosts): the registrant
            # already holds the current model, so the ack is
            # metadata-sized instead of shipping the full bundle once
            # per lane. Genuine handshakes send ver=-1 and still get
            # the bundle below.
            return msgpack.packb({"code": 1, "ver": version},
                                 use_bin_type=True)
        if first_time or known_version < 0:
            # Handshakes and explicit resyncs (re-poll with ver=-1) get
            # the full bundle unconditionally.
            version, bundle = self._owner.get_model()
            return msgpack.packb({"code": 1, "ver": version, "model": bundle},
                                 use_bin_type=True)
        if version > known_version:
            version, blob = self._model_update(known_version)
            return msgpack.packb({"code": 1, "ver": version, "model": blob},
                                 use_bin_type=True)
        # long poll: wait for a newer model or timeout
        deadline = time.monotonic() + self._owner.idle_timeout_s
        with self._owner._model_cv:
            while True:
                version = self._model_version()
                if version > known_version:
                    version, blob = self._model_update(known_version)
                    return msgpack.packb(
                        {"code": 1, "ver": version, "model": blob},
                        use_bin_type=True)
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not context.is_active():
                    return msgpack.packb({"code": 0, "ver": version})
                self._owner._model_cv.wait(timeout=min(remaining, 1.0))


class GrpcServerTransport(ServerTransport):
    #: GetActions rides this server in-band (see base.ServerTransport);
    #: every thin client parks one RPC thread per in-flight request, so
    #: max_workers bounds the serving fleet alongside the long-polls.
    supports_inband_infer = True

    def __init__(self, bind_addr: str, idle_timeout_s: float = 30.0,
                 max_workers: int = 128):
        # max_workers bounds concurrent RPCs, and every subscribed agent
        # parks one long-poll (ClientPoll) thread on the server: the pool
        # must exceed the fleet size or late joiners' handshakes starve
        # behind parked polls (observed at 64 actors with the old 16).
        # The reference's tonic server is async and has no such limit —
        # this is the sync-grpcio translation of that property.
        super().__init__()
        self._bind_addr = bind_addr
        self.idle_timeout_s = float(idle_timeout_s)
        self._max_workers = max_workers
        self._server: grpc.Server | None = None
        self._model_cv = threading.Condition()
        # In-band serving concurrency bound: at most half the RPC pool
        # may park in GetActions waits, so trajectory ingest and the
        # long-polls always keep worker headroom (see get_actions).
        self._infer_slots = threading.Semaphore(max(8, max_workers // 2))
        # publish here is a long-poll wakeup, not a broadcast: there are
        # no broadcast bytes to count.
        self._m = server_wire_metrics("grpc", include_publish_bytes=False)
        # Subscriber table for the relayrl_transport_subscribers
        # pull-gauge: on this pull plane a "stream" is a poll loop, so
        # count distinct poller ids seen within the last poll window
        # (idle timeout + grace). One-shot lane registrations age out.
        self._poll_table: dict[str, float] = {}
        self._poll_table_lock = threading.Lock()

    def _note_subscriber(self, agent_id: str) -> None:
        with self._poll_table_lock:
            self._poll_table[agent_id] = time.monotonic()
            if len(self._poll_table) > 65536:  # runaway-id guard
                self._prune_poll_table_locked()

    def _prune_poll_table_locked(self) -> None:
        horizon = time.monotonic() - (self.idle_timeout_s + 15.0)
        for aid in [a for a, t in self._poll_table.items() if t < horizon]:
            del self._poll_table[aid]

    def _subscriber_count(self) -> int:
        with self._poll_table_lock:
            self._prune_poll_table_locked()
            return len(self._poll_table)

    def start(self) -> None:
        from concurrent import futures

        import grpc

        from relayrl_tpu_torch.transport.base import register_subscriber_gauge

        register_subscriber_gauge("grpc", self._subscriber_count,
                                  bind=self._bind_addr)
        servicer = _Servicer(self)
        handlers = {
            "SendActions": grpc.unary_unary_rpc_method_handler(
                servicer.send_actions,
                request_deserializer=_identity, response_serializer=_identity),
            "ClientPoll": grpc.unary_unary_rpc_method_handler(
                servicer.client_poll,
                request_deserializer=_identity, response_serializer=_identity),
            "GetActions": grpc.unary_unary_rpc_method_handler(
                servicer.get_actions,
                request_deserializer=_identity, response_serializer=_identity),
            "StreamActions": grpc.stream_stream_rpc_method_handler(
                servicer.stream_actions,
                request_deserializer=_identity, response_serializer=_identity),
        }
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=self._max_workers),
            options=[("grpc.max_receive_message_length", 256 * 1024 * 1024),
                     ("grpc.max_send_message_length", 256 * 1024 * 1024)],
        )
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(_SERVICE, handlers),))
        self._server.add_insecure_port(self._bind_addr)
        self._server.start()

    def stop(self) -> None:
        if self._server is not None:
            with self._model_cv:
                self._model_cv.notify_all()
            self._server.stop(grace=1).wait()
            self._server = None

    def publish_model(self, version: int, bundle_bytes: bytes) -> None:
        # Models are pulled via ClientPoll long-polls; publishing just wakes
        # the waiters (ref: watch channel notify, training_grpc.rs:600-627).
        self._m["publish_total"].inc()
        with self._model_cv:
            self._model_cv.notify_all()


class GrpcAgentTransport(AgentTransport):
    def __init__(self, server_addr: str, identity: str | None = None,
                 poll_timeout_s: float = 35.0, retry: dict | None = None):
        super().__init__()
        import os
        import secrets

        from relayrl_tpu_torch import faults

        self._retry = RetryPolicy.from_dict(retry)
        self._fault_send = faults.site("agent.send")
        self._fault_model = faults.site("agent.model")
        self.identity = identity or f"AGENT_ID-{os.getpid()}{secrets.token_hex(4)}"
        self._addr = server_addr
        self._poll_timeout_s = poll_timeout_s
        self._channel_lock = threading.Lock()
        self._make_channel()
        self._known_version = -1
        self._inflight = None
        self._stop = threading.Event()
        self._listener: threading.Thread | None = None
        self._m = agent_wire_metrics("grpc")
        # Reconnect accounting matches the native backend's semantics:
        # count a HEAL (first successful poll after a break), not every
        # failed retry — a 60s server restart is ONE reconnect, not 60.
        self._poll_broken = False
        self._poll_fail_streak = 0
        # Pre-decode receipt ledger (base.ReceiptLedger), same surface
        # as the native C++ and zmq ledgers — soak fan-out accounting is
        # backend-uniform.
        self._ledger = ReceiptLedger()

    def _make_channel(self) -> None:
        """(Re)build the channel + stubs. Reconnect backoff is bounded by
        the SAME retry policy that drives the handshake: grpc's default
        channel backoff grows to ~2 minutes between dial attempts, so a
        learner restart could sit unreachable for the whole recovery
        window (observed in the SIGKILL drill)."""
        import grpc

        backoff_min_ms = max(50, int(self._retry.base_delay_s * 1000))
        backoff_max_ms = max(backoff_min_ms,
                             int(self._retry.max_delay_s * 1000))
        self._channel = grpc.insecure_channel(
            self._addr,
            options=[("grpc.max_receive_message_length", 256 * 1024 * 1024),
                     ("grpc.max_send_message_length", 256 * 1024 * 1024),
                     ("grpc.initial_reconnect_backoff_ms", backoff_min_ms),
                     ("grpc.min_reconnect_backoff_ms", backoff_min_ms),
                     ("grpc.max_reconnect_backoff_ms", backoff_max_ms)],
        )
        self._send = self._channel.unary_unary(
            f"/{_SERVICE}/SendActions",
            request_serializer=_identity, response_deserializer=_identity)
        self._poll = self._channel.unary_unary(
            f"/{_SERVICE}/ClientPoll",
            request_serializer=_identity, response_deserializer=_identity)

    def _rebuild_channel(self) -> None:
        """Replace a persistently-broken channel with a fresh one. A
        grpc-core channel whose server died mid-long-poll can wedge its
        subchannel in connect-timeout loops ("FD Shutdown") and never
        reach the restarted server even though a fresh dial succeeds
        immediately — observed in the learner SIGKILL drill. In-flight
        calls on the old channel fail over to the new one on their next
        attempt (retry/spool paths)."""
        with self._channel_lock:
            old = self._channel
            self._make_channel()
        try:
            old.close()
        except Exception:
            pass
        print(f"[grpc] channel to {self._addr} rebuilt after persistent "
              f"connection failure", flush=True)

    def _poll_once(self, first: bool, timeout_s: float,
                   known_version: int | None = None, record: bool = False):
        import msgpack

        req = msgpack.packb(
            {"id": self.identity,
             "ver": (self._known_version if known_version is None
                     else known_version),
             "first": first},
            use_bin_type=True)
        # future-based invocation so close() can cancel a parked long-poll
        # instead of waiting out its full timeout (64 agents x 35 s
        # otherwise serializes shutdown into minutes).
        call = self._poll.future(req, timeout=timeout_s)
        self._inflight = call
        try:
            raw = call.result()
        finally:
            self._inflight = None
        rx_ns = time.monotonic_ns()  # receipt stamp BEFORE decode
        resp = msgpack.unpackb(raw, raw=False)
        # A code-1 ack without a bundle (the servicer's metadata-only
        # registration reply) is not a model delivery.
        if resp.get("code") == 1 and "model" in resp:
            self._known_version = int(resp["ver"])
            if record:  # subscription deliveries only, not handshakes
                self._ledger.append(int(resp["ver"]), rx_ns)
                self._m["model_recv_total"].inc()
                self._m["model_recv_bytes"].inc(len(raw))
            return int(resp["ver"]), resp["model"], rx_ns
        return None

    def fetch_model(self, timeout_s: float = 60.0) -> tuple[int, bytes]:
        """Bounded connect/handshake retry under the unified RetryPolicy
        (the reference's init retry loop never decrements its counter and
        can spin forever, agent_grpc.rs:151-171; the old flat 0.2s sleep
        dialect here is replaced by the shared jittered backoff)."""
        import grpc

        deadline = time.monotonic() + timeout_s

        def attempt():
            # ver=-1 regardless of _known_version: a handshake wants
            # the bundle unconditionally — without it, a re-handshake
            # on a transport already at the server's version would
            # draw the metadata-only ack and spin to timeout.
            result = self._poll_once(first=True, timeout_s=min(
                5.0, max(0.1, deadline - time.monotonic())),
                known_version=-1)
            return None if result is None else (result[0], result[1])

        try:
            return self._retry.call(attempt, op="grpc.handshake",
                                    deadline_s=timeout_s,
                                    retry_on=(grpc.RpcError,))
        except (grpc.RpcError, TimeoutError) as e:
            raise TimeoutError(
                f"gRPC model handshake timed out: {e}") from None

    def register(self, agent_id: str | None = None, timeout_s: float = 10.0) -> bool:
        # The connection identity registers via the first_time ClientPoll
        # (one RPC fewer than the ZMQ plane); fetch_model() already did it.
        # A LOGICAL agent id (vector host lane) has no poll loop of its
        # own, so it registers with a one-shot first_time poll carrying
        # the CURRENT known version — the Python servicer then acks
        # metadata-only (no redundant bundle per lane; the native C++
        # gRPC server still ships the bundle, which is discarded — the
        # shared listener owns model delivery for the whole connection).
        if agent_id is None or agent_id == self.identity:
            return True
        import grpc
        import msgpack

        req = msgpack.packb({"id": agent_id, "ver": self._known_version,
                             "first": True}, use_bin_type=True)
        try:
            resp = msgpack.unpackb(self._poll(req, timeout=timeout_s),
                                   raw=False)
        except grpc.RpcError:
            return False
        return resp.get("code") == 1

    def send_trajectory(self, payload: bytes,
                        agent_id: str | None = None) -> None:
        import msgpack

        from relayrl_tpu_torch.transport.base import pack_trajectory_envelope

        env = pack_trajectory_envelope(agent_id or self.identity, payload)
        if self._fault_send is not None:
            parts = self._fault_send.inject(env)
            if not parts:
                # On an ack'd transport a lost request surfaces as a
                # timeout — raise so the caller (spool) retries/buffers,
                # the same failure shape a real drop produces.
                raise TimeoutError("fault-injected trajectory drop (grpc)")
        else:
            parts = ((0.0, env),)
        t0 = time.monotonic()
        for delay_s, part in parts:
            if delay_s > 0:
                time.sleep(delay_s)
            resp = msgpack.unpackb(self._send(part, timeout=30.0), raw=False)
            self._m["send_total"].inc()
            self._m["send_bytes"].inc(len(part))
            code = resp.get("code")
            if code in (NACK_QUARANTINED, NACK_OVERLOADED):
                # Typed guardrail nack: the server is alive and REFUSED
                # the send — not a wire failure (the spool must not
                # count it against the breaker; see spool._attempt).
                raise IngestNack(code, str(resp.get("error") or ""),
                                 float(resp.get("retry_after_s") or 0.0))
            if code != 1:
                raise RuntimeError(
                    f"trajectory rejected: {resp.get('error')}")
        self._m["send_seconds"].observe(time.monotonic() - t0)

    def start_model_listener(self) -> None:
        if self._listener is not None:
            return
        self._stop.clear()
        self._listener = threading.Thread(
            target=self._poll_loop, name="grpc-model-poll", daemon=True)
        self._listener.start()

    def _poll_loop(self) -> None:
        import grpc

        while not self._stop.is_set():
            try:
                result = self._poll_once(first=False,
                                         timeout_s=self._poll_timeout_s,
                                         record=True)
                if self._poll_broken:
                    # First successful poll after a break: that is the
                    # one reconnect (native counts heals the same way —
                    # semantics must match across backends). The shared
                    # notifier counts it AND fires on_reconnect (spool
                    # replay).
                    self._poll_broken = False
                    self._notify_reconnect()
                self._poll_fail_streak = 0
            except (grpc.RpcError, grpc.FutureCancelledError) as e:
                # FutureCancelledError: close() cancelled the parked poll.
                # A DEADLINE_EXCEEDED is the benign empty long-poll; any
                # other RpcError marks the channel broken until a poll
                # lands again.
                code = getattr(e, "code", lambda: None)()
                if (isinstance(e, grpc.RpcError)
                        and code != grpc.StatusCode.DEADLINE_EXCEEDED
                        and not self._stop.is_set()):
                    self._poll_broken = True
                    self._poll_fail_streak += 1
                    if self._poll_fail_streak >= 5:
                        # grpc-core can wedge a killed server's channel
                        # permanently — rebuild (see _rebuild_channel).
                        self._poll_fail_streak = 0
                        self._rebuild_channel()
                if self._stop.wait(1.0):
                    break
                continue
            if result is not None:
                version, bundle, rx_ns = result
                if self._fault_model is not None:
                    # chaos plane: lose/delay/corrupt the delivery after
                    # the poll returned (a dropped pull just re-polls; a
                    # corrupted one dies in the actor's decode guards
                    # and triggers the resync path).
                    for delay_s, part in self._fault_model.inject(bundle):
                        if delay_s > 0:
                            time.sleep(delay_s)
                        self.on_model(version, part)
                else:
                    self.on_model(version, bundle)
                self._m["model_deliver_seconds"].observe(
                    (time.monotonic_ns() - rx_ns) / 1e9)
                # Downstream trace receipt hop (no publisher stamp on the
                # pull plane: model age stays a broadcast-side
                # observation).
                from relayrl_tpu_torch.telemetry.trace import (
                    record_model_receipt,
                )

                record_model_receipt(version, rx_ns, None, "grpc")

    def drain_receipts(self, max_n: int = 65536) -> list[tuple[int, int]]:
        """Drain the pre-decode receipt ledger (same surface as the
        native C++ and zmq ledgers)."""
        return self._ledger.drain(max_n)

    def request_resync(self, held_version: int = -1) -> None:
        """Model-wire v2 resync: forget the held version so the next
        long-poll carries ``ver=-1`` and the server replies with a full
        bundle instead of an undecodable delta. ``held_version`` is
        irrelevant on this pull plane — the re-poll is the request."""
        self._known_version = -1

    def close(self, drain_s: float = 0.0) -> None:
        # A send is a unary call that returns once the server answered:
        # nothing is left to drain.
        self._stop.set()
        if self._listener is not None:
            # Cancel-in-a-loop: a single cancel can miss the window where
            # the listener is between polls and about to park a fresh
            # 35 s future (TOCTOU) — keep cancelling whatever is in
            # flight until the thread exits.
            deadline = time.monotonic() + 10
            while self._listener.is_alive() and time.monotonic() < deadline:
                inflight = self._inflight
                if inflight is not None:
                    inflight.cancel()
                self._listener.join(timeout=0.2)
            self._listener = None
        self._channel.close()
