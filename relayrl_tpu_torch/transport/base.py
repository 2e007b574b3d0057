"""Transport abstractions shared by ZMQ / gRPC / native backends.

The reference hard-wires its two transports into the server/agent classes
(reference: relayrl_framework/src/network/server/training_server_wrapper.rs:
329-379 picks TrainingServerZmq vs TrainingServerGrpc; the agent wrapper
likewise, src/network/client/agent_wrapper.rs:231-270). Here the runtime
composes against these two small interfaces, so ZMQ, gRPC, the C++ native
core, and the in-process test transport are interchangeable.

Wire protocol (same message surface as the reference, SURVEY.md §2.3):

* handshake:   agent → ``GET_MODEL``            → server replies model bundle
               agent → ``MODEL_SET <agent_id>`` → server replies ``ID_LOGGED``
* trajectory:  agent → envelope{agent_id, trajectory bytes} (fire-and-forget)
* model push:  server → broadcast {version, bundle bytes} to all agents

A copy of :mod:`relayrl_tpu.transport.base` with ``msgpack`` imported
inside the functions that use it, so importing the port loads no msgpack.

Logical-agent multiplexing (vector actor hosts): one connection may carry
N *logical* agents — ``register`` is callable N times with distinct ids,
each producing its own server-side registry entry, and ``send_trajectory``
takes an optional ``agent_id`` that stamps the envelope so per-agent
trajectory attribution survives the shared socket. The model subscription
stays per-connection (one receipt fans into every logical lane host-side).
"""

from __future__ import annotations

import abc
import threading
from collections import deque
from typing import Callable

# -- command frames (ref: GET_MODEL/MODEL_SET/ID_LOGGED strings,
#    training_zmq.rs:747-829) --
CMD_GET_MODEL = b"GET_MODEL"
CMD_MODEL_SET = b"MODEL_SET"
# Broadcast-plane resync request (relay plane): a subscriber
# whose delta base diverged asks the publisher for a keyframe instead of
# passively waiting out ``keyframe_interval`` publishes. Fire-and-forget
# (no reply frame): the heal IS the next broadcast. The root server
# answers with a coalesced, rate-limited ``force_keyframe``; a relay
# answers from its keyframe cache without touching the root.
CMD_RESYNC = b"RESYNC"
REPLY_MODEL = b"MODEL"
REPLY_ID_LOGGED = b"ID_LOGGED"
REPLY_ERROR = b"ERROR"
MODEL_TOPIC = b"model"


def pack_trajectory_envelope(agent_id: str, payload: bytes) -> bytes:
    """``payload`` is opaque to the transport plane: per-record msgpack
    (``types/trajectory.serialize_actions``), a columnar trajectory
    frame (``types/columnar.encode_columnar_frame`` — the anakin tier's
    wire form, sniffed server-side by the RLD1 magic), or a fleet
    telemetry snapshot frame (``telemetry/aggregate.py`` — ``RLS1``
    magic, id ``@fleet/<proc>``, sniffed at every ingest funnel and at
    relays; rides beside trajectories so the metrics plane needs no
    socket of its own). Envelopes carry attribution + the spool's
    ``#s<seq>`` tag identically for all three, so the whole delivery
    plane is wire-form-agnostic."""
    import msgpack

    return msgpack.packb({"id": agent_id, "traj": payload}, use_bin_type=True)


def unpack_trajectory_envelope(buf: bytes) -> tuple[str, bytes]:
    import msgpack

    env = msgpack.unpackb(buf, raw=False)
    return str(env.get("id", "?")), env["traj"]


# -- batch containers (shared framing helper) --
#
# One length-prefixed container serves BOTH coalescing paths:
#
# * ``BATCH_KIND_ENVELOPES`` — a relay's upstream forward: N whole
#   trajectory envelopes (each still carrying its own agent id + ``#s``
#   seq tag verbatim) ship as ONE wire send; the server's ingest funnel
#   splits the container and runs every inner envelope through the
#   normal per-agent dedup/guardrail path, so relay batching is
#   invisible to the exactly-once accounting.
# * ``BATCH_KIND_FRAMES`` — an anakin host's emit coalesce
#   (``actor.emit_coalesce_frames``): N completed columnar segments of
#   ONE logical lane ship as a single spooled send (one seq, one
#   envelope); a staging worker splits the container and decodes each
#   contained RLD1 frame.
#
# Layout: ``RLB1 | kind u8 | count u32le | (len u32le | part)*`` —
# self-delimiting, transport-opaque (every backend's envelope treats the
# payload as bytes; the native C++ core's raw fallback carries it to the
# Python funnel untouched).
BATCH_MAGIC = b"RLB1"
BATCH_KIND_ENVELOPES = 1
BATCH_KIND_FRAMES = 2
_BATCH_HDR = 4 + 1 + 4


def pack_batch(kind: int, parts: list[bytes]) -> bytes:
    out = bytearray(BATCH_MAGIC)
    out.append(kind)
    out += len(parts).to_bytes(4, "little")
    for part in parts:
        out += len(part).to_bytes(4, "little")
        out += part
    return bytes(out)


def batch_kind(buf) -> int | None:
    """The container kind, or None when ``buf`` is not a batch frame."""
    if len(buf) < _BATCH_HDR or bytes(buf[:4]) != BATCH_MAGIC:
        return None
    return buf[4]


def split_batch(buf) -> list[bytes]:
    """Container -> parts. Raises ``ValueError`` on a truncated or
    miscounted container (a data-shaped error the receive loops'
    decode-error narrowing already classifies as droppable)."""
    if batch_kind(buf) is None:
        raise ValueError("not a batch container")
    mv = memoryview(buf)
    count = int.from_bytes(mv[5:9], "little")
    off = _BATCH_HDR
    parts: list[bytes] = []
    for _ in range(count):
        if off + 4 > len(mv):
            raise ValueError("truncated batch container")
        n = int.from_bytes(mv[off:off + 4], "little")
        off += 4
        if off + n > len(mv):
            raise ValueError("truncated batch part")
        parts.append(bytes(mv[off:off + n]))
        off += n
    if off != len(mv):
        raise ValueError("batch container carries trailing bytes")
    return parts


# -- delivery sequence tags (crash-recovery plane, runtime/spool.py) --
#
# Per-agent monotonic sequence numbers ride as a SUFFIX on the envelope
# agent id ("<agent_id>#s<seq>") rather than a new envelope key: the id
# is an opaque attribution string through every backend INCLUDING the
# native C++ columnar fast path (codec.cc decode_envelope_to_blob carries
# the id verbatim but would drop an unknown envelope key on the decoded
# path), so one tagging scheme survives all three transports unchanged.
# The server's ingest funnel strips the tag before attribution and feeds
# the seq to its dedup ledger; ids without a tag (raw transport users,
# pre-spool fleets) pass through untouched.
_SEQ_TAG = "#s"


def tag_agent_seq(agent_id: str, seq: int) -> str:
    return f"{agent_id}{_SEQ_TAG}{int(seq)}"


def split_agent_seq(agent_id: str) -> tuple[str, int | None]:
    """``"a#s42" -> ("a", 42)``; untagged ids -> ``(agent_id, None)``."""
    base, sep, tail = agent_id.rpartition(_SEQ_TAG)
    if sep and tail.isdigit():
        return base, int(tail)
    return agent_id, None


# -- trace-context tags (distributed tracing, telemetry/trace.py) --
#
# A sampled trajectory's trace context rides the SAME envelope-id channel
# as the seq tag, immediately before it: ``<agent>#t<ctx>#s<seq>``. The
# ctx payload is three dot-separated lowercase-hex fields (trace id,
# born_ns, born_version — telemetry.trace.TrajCtx), validated strictly
# on split so an agent id that happens to contain ``#t`` cannot be
# misparsed. Coalescing with the id (instead of a new envelope key)
# is what makes the context survive the native C++ columnar raw-fallback
# path verbatim — codec.cc drops unknown envelope KEYS but carries the
# id untouched, the seq-tag lesson (locked by an explicit
# passthrough test in tests/test_trace.py).
_TRACE_TAG = "#t"
_CTX_HEX = set("0123456789abcdef-")


def tag_agent_trace(agent_id: str, ctx_text: str) -> str:
    return f"{agent_id}{_TRACE_TAG}{ctx_text}"


def split_agent_trace(agent_id: str) -> tuple[str, str | None]:
    """``"a#tdead.beef.2" -> ("a", "dead.beef.2")``; ids without a
    valid trace tag -> ``(agent_id, None)``. Call AFTER
    :func:`split_agent_seq` (the seq tag is outermost on the wire)."""
    base, sep, tail = agent_id.rpartition(_TRACE_TAG)
    if not sep:
        return agent_id, None
    parts = tail.split(".")
    if len(parts) != 3 or not all(
            p and all(c in _CTX_HEX for c in p) for p in parts):
        return agent_id, None
    return base, tail


def pack_model_frame(version: int, bundle_bytes: bytes,
                     pub_ns: int | None = None) -> bytes:
    """``pub_ns`` is the publisher's CLOCK_MONOTONIC stamp (same-host
    comparable — the soak bench's fan-out methodology): when present, a
    receiving SUB thread can compute its own publish→receipt latency
    without any cross-process glue. Omitted by default so handshake
    replies stay byte-stable; absent keys are simply not decoded."""
    frame = {"ver": int(version), "model": bundle_bytes}
    if pub_ns is not None:
        frame["pub_ns"] = int(pub_ns)
    import msgpack

    return msgpack.packb(frame, use_bin_type=True)


def unpack_model_frame_ex(buf: bytes) -> tuple[int, bytes, int | None]:
    """Decode a model frame: ``(version, bundle_bytes, pub_ns|None)``
    (``pub_ns`` absent in frames packed without a publisher stamp).
    The ONE decode path — :func:`unpack_model_frame` delegates here so
    a schema change can never drift between two decoders."""
    import msgpack

    frame = msgpack.unpackb(buf, raw=False)
    pub_ns = frame.get("pub_ns")
    return (int(frame["ver"]), frame["model"],
            None if pub_ns is None else int(pub_ns))


def unpack_model_frame(buf: bytes) -> tuple[int, bytes]:
    version, model, _ = unpack_model_frame_ex(buf)
    return version, model


# -- typed ingest nacks (guardrail plane) --
#
# Ack-capable transports (gRPC request/response; any future proto with a
# reply) carry the server's admission verdict back to the sender as a
# typed nack instead of a silent drop: code 2 = the sending agent is
# QUARANTINED (stop sending — the spool discards the entry; retrying is
# pointless until parole), code 3 = ingest OVERLOADED (keep the entry
# spooled and retry after ``retry_after_s``). Broadcast planes (zmq PUSH,
# native) have no per-send back-channel; there the same verdicts are
# enforced server-side and surface through telemetry/events only.
NACK_OK = 1
NACK_MALFORMED = 0
NACK_QUARANTINED = 2
NACK_OVERLOADED = 3
# Serving plane only: the endpoint exists but no InferenceService is
# installed (serving.enabled false / misconfigured fleet). PERMANENT —
# thin clients fail fast with the reply's error text instead of
# retrying a misconfiguration into a deadline exhaustion.
NACK_UNAVAILABLE = 4
# Serving plane only: the request named a session id the service no
# longer holds (LRU-evicted under serving.max_sessions, expired past
# serving.session_ttl_s, or a fresh replica after re-route/restart).
# RESYNC, not failure: the client answers by resending the same request
# with its episode window attached — session state is always
# reconstructible-from-client (the replica-death contract).
NACK_SESSION_EVICTED = 5


class IngestNack(RuntimeError):
    """A send the server REFUSED with a typed verdict (not a transport
    failure: the server is alive and answered — callers must not count
    it against circuit breakers or retry budgets)."""

    def __init__(self, code: int, reason: str = "",
                 retry_after_s: float = 0.0):
        super().__init__(f"ingest nack code={code}"
                         f"{f' ({reason})' if reason else ''}")
        self.code = int(code)
        self.reason = reason
        self.retry_after_s = float(retry_after_s)

    @property
    def quarantined(self) -> bool:
        return self.code == NACK_QUARANTINED


# -- receive-loop decode-error narrowing --
#
# The receive loops used to eat EVERY exception from a frame decode
# ("malformed frame: drop, never crash ingest"), which also swallowed
# genuine bugs. Decode sites now classify: data-shaped errors (anything a
# hostile/corrupt frame can provoke from msgpack/struct/np slicing) are
# dropped with a counter + one log line per site/type; everything else —
# AttributeError, NameError, OSError, MemoryError: states a corrupt frame
# cannot reach — re-raises and takes the loop down loudly.
TRANSIENT_DECODE_ERRORS = (
    ValueError,            # msgpack FormatError subclasses this; int() etc.
    KeyError,              # missing envelope keys
    TypeError,             # wrong msgpack container shapes
    IndexError,            # truncated frames
    OverflowError,
    UnicodeDecodeError,
)


def _transient_decode_errors() -> tuple:
    """:data:`TRANSIENT_DECODE_ERRORS` plus msgpack's own unpack errors
    (msgpack is imported here, on the first decode error, not at module
    import)."""
    import msgpack

    return TRANSIENT_DECODE_ERRORS + (msgpack.exceptions.UnpackException,
                                      msgpack.exceptions.StackError)

_swallow_logged: set[tuple[str, str, str]] = set()
_swallow_lock = threading.Lock()


def swallow_decode_error(backend: str, site: str, exc: Exception) -> None:
    """Account for (or refuse to swallow) one receive-loop decode error.

    Transient, data-shaped errors increment
    ``relayrl_transport_swallowed_errors_total{backend,site}`` and log
    once per (backend, site, type); anything else re-raises — a
    programming error must not be laundered as a malformed frame.
    """
    if not isinstance(exc, _transient_decode_errors()):
        raise exc
    from relayrl_tpu_torch import telemetry

    telemetry.get_registry().counter(
        "relayrl_transport_swallowed_errors_total",
        "malformed frames dropped by receive loops",
        {"backend": backend, "site": site}).inc()
    key = (backend, site, type(exc).__name__)
    with _swallow_lock:
        first = key not in _swallow_logged
        if first:
            _swallow_logged.add(key)
    if first:
        print(f"[{backend}] {site}: dropped malformed frame "
              f"({type(exc).__name__}: {exc}) — counted in "
              f"relayrl_transport_swallowed_errors_total; further "
              f"occurrences logged only to the counter", flush=True)


class ReceiptLedger:
    """Pre-decode model-receipt ledger: ``(version, rx_mono_ns)`` pairs
    stamped the moment a frame leaves the socket, drained destructively.
    The Python mirror of the native C++ reader's ledger
    (``rl_sub_receipts``), shared by the zmq and grpc agent transports
    so the stamping semantics and bounds can never drift between
    backends (the zmq 64-actor 0.433 lesson, benches/README.md)."""

    def __init__(self, maxlen: int = 65536):
        self._receipts: deque[tuple[int, int]] = deque(maxlen=maxlen)
        self._lock = threading.Lock()

    def append(self, version: int, rx_ns: int) -> None:
        with self._lock:
            self._receipts.append((version, rx_ns))

    def drain(self, max_n: int = 65536) -> list[tuple[int, int]]:
        with self._lock:
            out: list[tuple[int, int]] = []
            while self._receipts and len(out) < max_n:
                out.append(self._receipts.popleft())
            return out


def register_subscriber_gauge(backend: str, fn, bind: str = "") -> None:
    """Install the ``relayrl_transport_subscribers`` pull-gauge for one
    server transport (the fan-out observability
    gap). ``fn`` reads the backend's live registry/connection table at
    snapshot time — zmq counts PUB-socket peers via its socket monitor,
    grpc counts fresh long-poll connections, native counts its
    registered-connection table. A relay tree is then verifiable live:
    the root publisher's gauge equals the RELAY count, not the actor
    count. ``bind`` (the publisher's bind address) distinguishes
    instances — a process hosting two same-backend server transports
    (an in-process relay next to a root) must not clobber one gauge
    with the other's table."""
    from relayrl_tpu_torch import telemetry

    labels = {"backend": backend}
    if bind:
        labels["bind"] = bind
    telemetry.get_registry().gauge_fn(
        "relayrl_transport_subscribers", fn,
        "current model-plane subscribers (streams) on this publisher",
        labels)


def server_wire_metrics(backend: str,
                        include_publish_bytes: bool = True) -> dict:
    """The server-side transport instrument set (one per backend,
    process-aggregated; null objects when telemetry is disabled):
    ``recv_total``/``recv_bytes`` for trajectory ingest and
    ``publish_total``(/``publish_bytes``) for model broadcasts.
    ``include_publish_bytes=False`` for pull-based planes (grpc long
    polls) where no broadcast bytes exist to count."""
    from relayrl_tpu_torch import telemetry

    reg = telemetry.get_registry()
    labels = {"backend": backend}
    metrics = {
        "recv_total": reg.counter(
            "relayrl_transport_recv_total",
            "trajectory envelopes received at ingest", labels),
        "recv_bytes": reg.counter(
            "relayrl_transport_recv_bytes_total",
            "trajectory wire bytes received", labels),
        "publish_total": reg.counter(
            "relayrl_transport_publish_total",
            "model publishes", labels),
    }
    if include_publish_bytes:
        metrics["publish_bytes"] = reg.counter(
            "relayrl_transport_publish_bytes_total",
            "model broadcast bytes sent", labels)
    return metrics


def _wide_buckets():
    from relayrl_tpu_torch.telemetry.core import LATENCY_BUCKETS_WIDE

    return LATENCY_BUCKETS_WIDE


def agent_wire_metrics(backend: str) -> dict:
    """The shared agent-side transport instrument set, one registry
    lookup per connection (all metrics are process-aggregated across
    connections of the same backend; null objects when telemetry is
    disabled). Keys:

    * ``send_total`` / ``send_bytes``  — trajectory sends + wire bytes
    * ``send_seconds``                 — per-send latency histogram
    * ``model_recv_total`` / ``model_recv_bytes`` — model frames received
    * ``model_deliver_seconds``        — SUB/poll thread time from the
      pre-decode receipt stamp to ``on_model`` returning (decode + swap
      + persist): the per-receipt cost that starves Python SUB threads
      at fleet fan-out rates (benches/README.md, zmq 64-actor row)
    * ``receipt_latency_seconds``      — publish→receipt when the frame
      carries the publisher's monotonic stamp (same-host pairs only)
    * ``reconnects``                   — transport heals/redials
    """
    from relayrl_tpu_torch import telemetry

    reg = telemetry.get_registry()
    labels = {"backend": backend}
    return {
        "send_total": reg.counter(
            "relayrl_transport_send_total",
            "trajectory payloads sent", labels),
        "send_bytes": reg.counter(
            "relayrl_transport_send_bytes_total",
            "trajectory wire bytes sent (envelope included)", labels),
        # Wide log-spaced grids (telemetry.core.LATENCY_BUCKETS_WIDE)
        # for the two per-op latencies that saturate the default 10 s
        # grid at relay/pod scale: a send riding out an open-breaker
        # stall and a model delivery behind a backed-up SUB thread both
        # legitimately reach tens of seconds, and a grid that pins them
        # in +Inf cannot localize the tail.
        "send_seconds": reg.histogram(
            "relayrl_transport_send_seconds",
            "one trajectory send on the caller thread", labels,
            buckets=_wide_buckets()),
        "model_recv_total": reg.counter(
            "relayrl_transport_model_recv_total",
            "model frames received on the subscription", labels),
        "model_recv_bytes": reg.counter(
            "relayrl_transport_model_recv_bytes_total",
            "model frame bytes received", labels),
        "model_deliver_seconds": reg.histogram(
            "relayrl_transport_model_deliver_seconds",
            "receipt stamp to on_model return (decode+swap+persist)",
            labels, buckets=_wide_buckets()),
        "receipt_latency_seconds": reg.histogram(
            "relayrl_transport_receipt_latency_seconds",
            "publish stamp to receipt stamp, same-host monotonic pairs",
            labels),
        "reconnects": reg.counter(
            "relayrl_transport_reconnects_total",
            "connection heals/redials observed", labels),
    }


class ServerTransport(abc.ABC):
    """Server-side: accept handshakes, ingest trajectories, publish models.

    ``on_trajectory(agent_id, payload)`` is invoked from transport threads —
    implementations must be thread-safe; the training server funnels into a
    queue.
    ``get_model()`` returns the current ``(version, bundle_bytes)`` for
    handshakes.
    ``on_register(agent_id)`` records an agent (multi-actor registry,
    ref: training_server_wrapper.rs:159-163).
    ``get_model_update(known_version)`` is the model-wire v2 pull
    surface: the freshest frame a subscriber holding ``known_version``
    can decode (a delta when its base matches, else a full bundle).
    Backends with per-subscriber delivery (gRPC long-polls) prefer it
    when set; broadcast backends never call it. None means "no encoder
    — serve get_model()".
    """

    #: True when this backend's native core answers handshakes itself
    #: from bytes pushed at publish time (set_model) — the embedding
    #: server must then pass ``handshake_bytes`` (a full v1 bundle)
    #: alongside any v2 ``publish_model`` frame.
    needs_handshake_bytes = False

    #: True when this backend carries the serving plane in-band (a
    #: request/response action RPC routed through ``on_infer``) — the
    #: pure-grpcio backend's ``GetActions``. Broadcast backends and the
    #: native C++ cores leave it False; their fleets serve inference on
    #: the dedicated zmq ROUTER plane instead.
    supports_inband_infer = False

    def __init__(self):
        self.on_trajectory: Callable[[str, bytes], None] = lambda *_: None
        self.get_model: Callable[[], tuple[int, bytes]] = lambda: (0, b"")
        self.get_model_update = None
        # Guardrail admission pre-check for ack-capable backends:
        # ``check_ingest(agent_id) -> None | (nack_code, reason,
        # retry_after_s)``. A non-None verdict is returned to the sender
        # as a typed nack INSTEAD of invoking on_trajectory. None (the
        # default) admits everything; broadcast backends never call it.
        self.check_ingest = None
        # Cheap current-version probe (no bundle serialize): long-poll
        # wakeup checks want the version alone — under wire v2 the full
        # v1 bytes serialize lazily, and probing through get_model()
        # would serialize a bundle nobody ships. None -> get_model()[0].
        self.get_model_version = None
        self.on_register: Callable[[str], None] = lambda *_: None
        # Broadcast-plane resync requests (CMD_RESYNC, relay plane): a
        # subscriber's delta base diverged and it wants a keyframe
        # sooner than the interval. Called as ``on_resync(held_version)``
        # — the requester's held model version, or -1 when unknown. The
        # training server binds a coalesced rate-limited force_keyframe
        # (version-blind); a relay compares against its keyframe cache:
        # a late joiner below the cache is served locally, a mid-stream
        # divergence ABOVE it escalates upstream (the cache cannot heal
        # a subscriber newer than itself — decoders drop stale
        # versions). Default no-op — pull transports never need it.
        self.on_resync: Callable[..., None] = lambda *_: None
        # Elastic fleets: fired when a registered agent's connection dies
        # (native transport's crash/idle detection; other backends may
        # never call it).
        self.on_unregister: Callable[[str], None] = lambda *_: None
        # Optional fast path: transports whose native core decodes
        # trajectories into columnar form (native batch drain) deliver
        # DecodedTrajectory objects here when the embedder sets it; raw
        # payload bytes always fall back to ``on_trajectory``.
        self.on_trajectory_decoded = None
        # Serving plane (disaggregated batched inference,
        # transport/serving.py): backends with an in-band
        # request/response action RPC (pure-grpcio ``GetActions``) call
        # ``on_infer(request_bytes) -> reply_bytes`` when the embedder
        # set it — the InferenceService's blocking adapter. None (the
        # default, and on every broadcast-only backend) answers clients
        # with a pointed "serving disabled" error instead of hanging.
        self.on_infer = None
        # Streamed serving plane (pipelined bidi inference,
        # ``StreamActions``): backends with a bidi action stream call
        # ``on_infer_submit(request_bytes, reply) -> bool`` per inbound
        # frame — the InferenceService's non-blocking enqueue, which
        # ALWAYS eventually invokes ``reply(reply_bytes)`` (served,
        # nacked, or shed at stop). None disables the stream RPC with a
        # typed unavailable nack, exactly like ``on_infer``.
        self.on_infer_submit = None

    @abc.abstractmethod
    def start(self) -> None: ...

    @abc.abstractmethod
    def stop(self) -> None: ...

    @abc.abstractmethod
    def publish_model(self, version: int, bundle_bytes: bytes) -> None:
        """Broadcast a fresh model to every connected agent."""


class AgentTransport(abc.ABC):
    """Agent-side: handshake, trajectory send, model-update subscription.

    Backends that stamp model receipts pre-decode additionally expose
    ``drain_receipts() -> [(version, rx_mono_ns), ...]`` — the native
    C++ ledger's surface, mirrored in Python by the zmq/grpc listeners
    so fan-out accounting (benches/bench_soak.py) is backend-uniform.
    """

    def __init__(self):
        self.on_model: Callable[[int, bytes], None] = lambda *_: None
        # Reconnect notification (crash-recovery plane): fired from a
        # transport thread when this connection demonstrably healed after
        # a break — zmq via a socket-monitor CONNECTED-after-DISCONNECTED
        # pair, grpc on the first successful poll after a broken channel,
        # native on a ping-heal redial. The agent hooks it to replay its
        # trajectory spool (runtime/spool.py); the server's idempotent
        # ingest makes that replay safe.
        self.on_reconnect: Callable[[], None] = lambda: None

    def _notify_reconnect(self) -> None:
        """Count + forward one observed heal (shared by the backends so
        the reconnect metric and the callback can never drift apart);
        callback errors are isolated — a replay bug must not kill the
        transport thread that noticed the heal."""
        m = getattr(self, "_m", None)
        if m is not None:
            m["reconnects"].inc()
        try:
            self.on_reconnect()
        except Exception as e:
            print(f"[transport] on_reconnect handler failed: {e!r}",
                  flush=True)

    @abc.abstractmethod
    def fetch_model(self, timeout_s: float = 60.0) -> tuple[int, bytes]:
        """Blocking initial handshake: returns (version, bundle bytes)
        (ref: initial_model_handshake, agent_zmq.rs:316-442)."""

    @abc.abstractmethod
    def register(self, agent_id: str, timeout_s: float = 10.0) -> bool:
        """MODEL_SET/ID_LOGGED registration. May be called multiple times
        with distinct ids: each registers one logical agent on this
        connection (vector actor hosts multiplex N lanes over one socket).
        """

    @abc.abstractmethod
    def send_trajectory(self, payload: bytes,
                        agent_id: str | None = None) -> None:
        """Ship one serialized trajectory (per-record msgpack or a
        columnar frame — opaque bytes either way, see
        :func:`pack_trajectory_envelope`). ``agent_id`` stamps the wire
        envelope (defaults to the connection identity) — vector hosts pass
        the owning logical lane's id so server-side attribution is
        per-logical-agent, not per-socket."""

    @abc.abstractmethod
    def start_model_listener(self) -> None:
        """Begin delivering model updates to ``on_model`` asynchronously."""

    def request_resync(self, held_version: int = -1) -> None:
        """Model-wire v2 resync hook: ask the server for a full model on
        the next delivery. ``held_version`` is the caller's decoder
        version when known (WireBaseMismatch carries it) — it rides the
        zmq CMD_RESYNC so a RELAY can decide cache-serve vs escalate;
        the root publisher ignores it. Pull transports (gRPC) re-poll
        with ``ver=-1``; transports without a back-channel rely on the
        publisher's periodic keyframes — the default no-op."""

    @abc.abstractmethod
    def close(self, drain_s: float = 0.0) -> None:
        """Close the connection. ``drain_s`` bounds a wait for frames
        already handed to :meth:`send_trajectory` to leave; transports
        whose sends complete before they return have nothing to wait for."""
