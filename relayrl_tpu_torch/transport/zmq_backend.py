"""ZeroMQ transport backend.

Capability parity with the reference's ZMQ plane
(reference: relayrl_framework/src/network/server/training_zmq.rs — ROUTER
agent-listener at :669-864, PULL trajectory ingest at :948-1058, model push
at :876-934; client side src/network/client/agent_zmq.rs — DEALER handshake
at :316-442, PUSH trajectory via types/trajectory.rs:69-90, model listener
thread at :625-698).

Deliberate redesigns (documented, SURVEY.md §7.5):

* **PUB/SUB model broadcast.** The reference has the *agent* bind a PULL
  socket and the server connect per update (agent_zmq.rs:632-638 /
  training_zmq.rs:921-927) — one bind address means >1 agent cannot receive
  models. Server-side PUB with agent-side SUB is the topology that actually
  broadcasts; it's why the north-star "64 ZMQ actors" config is reachable.
* **Blocking polls, not 50 ms sleep loops.** All reference loops poll
  non-blocking sockets every 50 ms (training_zmq.rs:860,1053), a latency
  floor and a busy-wait; here every loop blocks in ``zmq.Poller`` with a
  shutdown-check timeout.
* **Persistent PUSH socket.** The reference opens a fresh PUSH connection per
  trajectory send (trajectory.rs:69-90); here one connected socket per agent.
* **A draining close.** A PUSH send only queues the frame for the context's
  I/O thread. An agent transport owns its context, so ``close(drain_s)``
  can wait, bounded, for the frames already queued (a closing fleet frame,
  a spool's last replays) to leave before the process moves on or exits.

A copy of :mod:`relayrl_tpu.transport.zmq_backend`.
"""

from __future__ import annotations

import threading
import time

import zmq

from relayrl_tpu_torch.transport.base import (
    AgentTransport,
    CMD_GET_MODEL,
    CMD_MODEL_SET,
    CMD_RESYNC,
    MODEL_TOPIC,
    REPLY_ERROR,
    REPLY_ID_LOGGED,
    REPLY_MODEL,
    ReceiptLedger,
    ServerTransport,
    agent_wire_metrics,
    pack_model_frame,
    register_subscriber_gauge,
    server_wire_metrics,
    swallow_decode_error,
    unpack_model_frame,
    unpack_model_frame_ex,
    unpack_trajectory_envelope,
)
from relayrl_tpu_torch.transport.retry import RetryPolicy

_POLL_MS = 100  # shutdown-check cadence for otherwise-blocking polls


def _bind_with_retry(sock: zmq.Socket, addr: str, timeout_s: float = 3.0) -> None:
    """Bind, tolerating the brief window where a just-closed socket's port is
    still being released (restart_server re-binds the same addresses)."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            sock.bind(addr)
            return
        except zmq.ZMQError as e:
            if e.errno != zmq.EADDRINUSE or time.monotonic() >= deadline:
                raise
            time.sleep(0.05)


class ZmqServerTransport(ServerTransport):
    """ROUTER handshake + PULL trajectory ingest + PUB model broadcast."""

    def __init__(self, agent_listener_addr: str, trajectory_addr: str,
                 model_pub_addr: str, chunk_bytes: int = 0):
        super().__init__()
        self._addrs = (agent_listener_addr, trajectory_addr, model_pub_addr)
        self._ctx: zmq.Context | None = None
        self._pub: zmq.Socket | None = None
        self._pub_lock = threading.Lock()
        # transport.chunk_bytes: broadcast frames above this size are
        # split into ordered chunk frames (modelwire.split_frame) so the
        # PUB socket's HWM accounting sees bounded messages; 0 = off.
        self._chunk_bytes = max(0, int(chunk_bytes))
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._m = server_wire_metrics("zmq")
        # Live subscriber (stream) count for the PUB plane, maintained
        # from the socket monitor's ACCEPTED/DISCONNECTED events and
        # read lazily by the relayrl_transport_subscribers pull-gauge —
        # libzmq has no direct peer-count API, but the bind-side monitor
        # sees every SUB connect/drop.
        self._pub_monitor: zmq.Socket | None = None
        self._sub_count = 0
        self._sub_count_lock = threading.Lock()

    def start(self) -> None:
        self._stop.clear()
        self._ctx = zmq.Context.instance()
        listener_addr, traj_addr, pub_addr = self._addrs
        self._pub = self._ctx.socket(zmq.PUB)
        try:
            self._pub_monitor = self._pub.get_monitor_socket(
                zmq.EVENT_ACCEPTED | zmq.EVENT_DISCONNECTED)
        except (zmq.ZMQError, AttributeError):
            self._pub_monitor = None  # monitor unsupported: gauge stays 0
        _bind_with_retry(self._pub, pub_addr)
        register_subscriber_gauge("zmq", self._subscriber_count,
                                  bind=pub_addr)
        self._threads = [
            threading.Thread(target=self._listener_loop, args=(listener_addr,),
                             name="zmq-agent-listener", daemon=True),
            threading.Thread(target=self._trajectory_loop, args=(traj_addr,),
                             name="zmq-trajectory-ingest", daemon=True),
        ]
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        self._threads.clear()
        with self._sub_count_lock:  # vs a concurrent gauge read
            if self._pub_monitor is not None:
                try:
                    self._pub_monitor.close(linger=0)
                except zmq.ZMQError:
                    pass
                self._pub_monitor = None
            # The socket (and every peer) dies with this stop; without
            # the reset a restart_server cycle would stack the old count
            # under the reconnecting peers' fresh ACCEPTED events.
            self._sub_count = 0
        if self._pub is not None:
            self._pub.close(linger=0)
            self._pub = None

    def _subscriber_count(self) -> int:
        """Pull-gauge read: drain queued PUB monitor events, return the
        live peer count. Runs on the snapshot/export thread only; the
        lock covers a concurrent stop() closing the monitor."""
        with self._sub_count_lock:
            mon = self._pub_monitor
            if mon is None:
                return self._sub_count
            try:
                from zmq.utils.monitor import recv_monitor_message

                while mon.poll(0):
                    evt = recv_monitor_message(mon)["event"]
                    if evt == zmq.EVENT_ACCEPTED:
                        self._sub_count += 1
                    elif evt == zmq.EVENT_DISCONNECTED:
                        self._sub_count = max(0, self._sub_count - 1)
            except (zmq.ZMQError, KeyError, OSError):
                pass  # monitor died mid-read: report the last known count
            return self._sub_count

    def publish_model(self, version: int, bundle_bytes: bytes) -> None:
        if self._pub is None:
            raise RuntimeError("transport not started")
        from relayrl_tpu_torch.transport.modelwire import split_frame

        # The publisher's monotonic stamp rides the frame so every SUB
        # thread on this host can compute publish→receipt latency
        # locally (the telemetry answer to the soak bench's fan-out
        # methodology; cross-host stamps don't pair and are ignored).
        # A model blob over chunk_bytes ships as ordered chunk frames
        # under ONE lock hold, so no other publish can interleave; the
        # agent-side ChunkReassembler restores the original frame.
        parts = split_frame(bundle_bytes, self._chunk_bytes, version)
        sent = 0
        with self._pub_lock:
            for part in parts:
                frame = pack_model_frame(version, part,
                                         pub_ns=time.monotonic_ns())
                self._pub.send_multipart([MODEL_TOPIC, frame])
                sent += len(frame)
        self._m["publish_total"].inc()
        self._m["publish_bytes"].inc(sent)

    # -- loops --
    def _listener_loop(self, addr: str) -> None:
        """ROUTER: GET_MODEL → model reply; MODEL_SET → register + ID_LOGGED
        (ref: _listen_for_agents, training_zmq.rs:669-864 — minus the
        break-after-first-registration single-actor quirk at :826-829)."""
        sock = self._ctx.socket(zmq.ROUTER)
        _bind_with_retry(sock, addr)
        poller = zmq.Poller()
        poller.register(sock, zmq.POLLIN)
        try:
            while not self._stop.is_set():
                if not dict(poller.poll(_POLL_MS)):
                    continue
                frames = sock.recv_multipart()
                # ROUTER framing: [identity, (empty,) cmd, args...]
                identity, rest = frames[0], frames[1:]
                if rest and rest[0] == b"":
                    rest = rest[1:]
                if not rest:
                    continue
                cmd = rest[0]
                if cmd == CMD_GET_MODEL:
                    version, bundle = self.get_model()
                    sock.send_multipart(
                        [identity, REPLY_MODEL, pack_model_frame(version, bundle)])
                elif cmd == CMD_MODEL_SET:
                    agent_id = rest[1].decode() if len(rest) > 1 else identity.decode(
                        errors="replace")
                    self.on_register(agent_id)
                    sock.send_multipart([identity, REPLY_ID_LOGGED])
                elif cmd == CMD_RESYNC:
                    # Fire-and-forget keyframe request (no reply — the
                    # heal is the next broadcast). The optional second
                    # frame carries the requester's held version so a
                    # relay can pick cache-serve vs escalate; the
                    # training server coalesces into one rate-limited
                    # force_keyframe regardless.
                    held = -1
                    if len(rest) > 1:
                        try:
                            held = int(rest[1])
                        except ValueError:
                            pass
                    try:
                        self.on_resync(held)
                    except Exception as e:
                        print(f"[zmq] on_resync handler failed: {e!r}",
                              flush=True)
                else:
                    sock.send_multipart([identity, REPLY_ERROR, b"unknown command"])
        finally:
            sock.close(linger=0)

    def _trajectory_loop(self, addr: str) -> None:
        """PULL ingest (ref: _start_training_loop recv half,
        training_zmq.rs:948-1011)."""
        sock = self._ctx.socket(zmq.PULL)
        _bind_with_retry(sock, addr)
        poller = zmq.Poller()
        poller.register(sock, zmq.POLLIN)
        try:
            while not self._stop.is_set():
                if not dict(poller.poll(_POLL_MS)):
                    continue
                buf = sock.recv()
                self._m["recv_total"].inc()
                self._m["recv_bytes"].inc(len(buf))
                try:
                    agent_id, payload = unpack_trajectory_envelope(buf)
                except Exception as e:
                    # Malformed frame: drop WITH a trace (counter + one
                    # log line); non-data errors re-raise — see
                    # base.swallow_decode_error.
                    swallow_decode_error("zmq", "trajectory_ingest", e)
                    continue
                self.on_trajectory(agent_id, payload)
        finally:
            sock.close(linger=0)


class ZmqAgentTransport(AgentTransport):
    """DEALER handshake + PUSH trajectories + SUB model updates."""

    def __init__(self, agent_listener_addr: str, trajectory_addr: str,
                 model_sub_addr: str, identity: str | None = None,
                 retry: dict | None = None):
        super().__init__()
        import os
        import secrets

        from relayrl_tpu_torch import faults

        self._identity = (identity or
                          f"AGENT_ID-{os.getpid()}{secrets.token_hex(4)}").encode()
        # Its own context, not the process's shared one: close() terms it,
        # which is the only way to wait for the PUSH pipe to empty.
        self._ctx = zmq.Context()
        self._addrs = (agent_listener_addr, trajectory_addr, model_sub_addr)
        self._dealer = self._ctx.socket(zmq.DEALER)
        self._dealer.setsockopt(zmq.IDENTITY, self._identity)
        self._dealer.connect(agent_listener_addr)
        self._push = self._ctx.socket(zmq.PUSH)
        self._push.connect(trajectory_addr)
        # Reconnect detection for a broadcast-plane transport with no
        # request/response back-channel: a zmq socket monitor on the PUSH
        # pipe reports DISCONNECTED/CONNECTED transitions from libzmq's
        # own reconnect machinery — a CONNECTED after a DISCONNECTED is
        # the server-restart signal that fires on_reconnect (spool
        # replay). Polled from the model-listener thread.
        self._push_monitor: zmq.Socket | None = None
        try:
            self._push_monitor = self._push.get_monitor_socket(
                zmq.EVENT_CONNECTED | zmq.EVENT_DISCONNECTED)
        except (zmq.ZMQError, AttributeError):
            pass  # monitor unsupported: replay falls back to explicit paths
        self._push_broken = False
        self._push_lock = threading.Lock()
        self._dealer_lock = threading.Lock()
        self._sub: zmq.Socket | None = None
        self._listener: threading.Thread | None = None
        self._stop = threading.Event()
        self._m = agent_wire_metrics("zmq")
        # Unified retry policy (transport.retry config) drives the
        # handshake re-poll cadence; fault sites are None without a plan.
        self._retry = RetryPolicy.from_dict(retry)
        self._fault_send = faults.site("agent.send")
        self._fault_model = faults.site("agent.model")
        # Pre-decode receipt ledger (base.ReceiptLedger — the native C++
        # ledger's Python mirror): (version, rx_mono_ns) stamped the
        # moment recv returns, BEFORE the frame is decoded or the swap
        # runs — so fan-out accounting measures the wire, not the Python
        # decode backlog behind it (benches/README.md zmq 64-actor note).
        self._ledger = ReceiptLedger()
        # Chunked model frames (server transport.chunk_bytes) reassemble
        # here before the ledger stamp / on_model, so one publish is one
        # receipt no matter how many wire messages carried it.
        from relayrl_tpu_torch.transport.modelwire import ChunkReassembler

        self._reasm = ChunkReassembler()

    @property
    def identity(self) -> str:
        return self._identity.decode()

    def _dealer_request(self, frames: list[bytes], timeout_s: float,
                        want: bytes):
        """Send a request and wait for a reply whose first frame is ``want``.

        Replies of other types are discarded: the handshake may re-send
        GET_MODEL on a slow server, leaving stale MODEL replies queued ahead
        of a later ID_LOGGED — request/response pairing on a DEALER is by
        reply type, not ordering.
        """
        # _dealer_lock: zmq sockets are not thread-safe, and reconnect-
        # time re-registration (Agent._on_reconnect, fired from a
        # listener thread) may race a handshake on the caller thread.
        with self._dealer_lock:
            deadline = time.monotonic() + timeout_s
            poller = zmq.Poller()
            poller.register(self._dealer, zmq.POLLIN)
            self._dealer.send_multipart(frames)
            while time.monotonic() < deadline:
                if dict(poller.poll(_POLL_MS)):
                    # deliberate blocking-under-lock: the lock EXISTS to
                    # serialize whole request/reply exchanges on the
                    # non-thread-safe DEALER; poll() above guarantees
                    # recv returns immediately, and the hold is bounded
                    # by the caller's timeout_s.
                    reply = self._dealer.recv_multipart()  # torchlint: disable=CONC01
                    if reply and reply[0] == want:
                        return reply
            return None

    def fetch_model(self, timeout_s: float = 60.0) -> tuple[int, bytes]:
        """Retrying GET_MODEL handshake under the unified RetryPolicy
        (ref: agent_zmq.rs:316-442 retries every 1 s forever; previously
        a hand-rolled fixed-2s re-poll dialect here — now the one
        jittered-backoff policy all three backends share)."""
        deadline = time.monotonic() + timeout_s

        def attempt():
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            reply = self._dealer_request([CMD_GET_MODEL],
                                         min(remaining, 2.0),
                                         want=REPLY_MODEL)
            if reply and len(reply) > 1:
                return unpack_model_frame(reply[1])
            return None

        try:
            return self._retry.call(attempt, op="zmq.handshake",
                                    deadline_s=timeout_s)
        except TimeoutError:
            raise TimeoutError(
                f"model handshake timed out after {timeout_s}s "
                f"(server at {self._addrs[0]} unreachable?)") from None

    def register(self, agent_id: str | None = None, timeout_s: float = 10.0) -> bool:
        reply = self._dealer_request(
            [CMD_MODEL_SET, (agent_id or self.identity).encode()], timeout_s,
            want=REPLY_ID_LOGGED)
        return reply is not None

    def send_trajectory(self, payload: bytes,
                        agent_id: str | None = None) -> None:
        from relayrl_tpu_torch.transport.base import pack_trajectory_envelope

        env = pack_trajectory_envelope(agent_id or self.identity, payload)
        if self._fault_send is not None:
            if self._fault_send.take_kill_connection():
                self._kill_push()
            parts = self._fault_send.inject(env)
        else:
            parts = ((0.0, env),)
        t0 = time.monotonic()
        for delay_s, part in parts:
            if delay_s > 0:
                time.sleep(delay_s)  # before the lock: a chaos delay
                #                      must not serialize sibling senders
            with self._push_lock:
                self._push.send(part)
            self._m["send_total"].inc()
            self._m["send_bytes"].inc(len(part))
        self._m["send_seconds"].observe(time.monotonic() - t0)

    def _kill_push(self) -> None:
        """Fault-plane connection kill: tear down the PUSH socket the way
        a TCP RST would (queued frames lost) and reconnect fresh — the
        recovery the spool's replay-on-reconnect covers."""
        with self._push_lock:
            if self._push_monitor is not None:
                try:
                    self._push_monitor.close(linger=0)
                except zmq.ZMQError:
                    pass
            self._push_monitor = None
            self._push.close(linger=0)
            self._push = self._ctx.socket(zmq.PUSH)
            # zmq connect is asynchronous (returns before any TCP
            # handshake) — not a blocking call, and the swap must be
            # atomic against concurrent senders holding this lock.
            self._push.connect(self._addrs[1])  # torchlint: disable=CONC01
            try:
                self._push_monitor = self._push.get_monitor_socket(
                    zmq.EVENT_CONNECTED | zmq.EVENT_DISCONNECTED)
            except (zmq.ZMQError, AttributeError):
                pass

    def start_model_listener(self) -> None:
        if self._listener is not None:
            return
        self._sub = self._ctx.socket(zmq.SUB)
        self._sub.connect(self._addrs[2])
        self._sub.setsockopt(zmq.SUBSCRIBE, MODEL_TOPIC)
        self._stop.clear()
        self._listener = threading.Thread(
            target=self._model_loop, name="zmq-model-listener", daemon=True)
        self._listener.start()

    def _model_loop(self) -> None:
        """SUB loop → on_model (ref: OS-thread PULL listener,
        agent_zmq.rs:625-698).

        The receipt stamp is taken the moment ``recv`` returns — before
        decode, before the (lock-contended) swap in ``on_model`` — and
        appended to the ledger right after the version is known. The
        decode/swap cost is measured separately
        (``model_deliver_seconds``): under fleet fan-out rates that cost
        is what backs this thread up, and stamping after it (the old
        behavior) conflated wire delivery with Python scheduling."""
        poller = zmq.Poller()
        poller.register(self._sub, zmq.POLLIN)
        while not self._stop.is_set():
            self._drain_monitor()
            if not dict(poller.poll(_POLL_MS)):
                continue
            frames = self._sub.recv_multipart()
            rx_ns = time.monotonic_ns()  # pre-decode receipt stamp
            if len(frames) != 2 or frames[0] != MODEL_TOPIC:
                continue
            raw_frames = [frames[1]]
            if self._fault_model is not None:
                # chaos plane: drop/delay/corrupt/duplicate the model
                # frame between the wire and the decode — a corrupted
                # frame must die in the CRC/decode guards below, a
                # dropped one waits out the keyframe cadence.
                raw_frames = []
                for delay_s, part in self._fault_model.inject(frames[1]):
                    if delay_s > 0:
                        time.sleep(delay_s)
                    raw_frames.append(part)
            for raw in raw_frames:
                self._deliver_model_frame(raw, rx_ns)

    def _deliver_model_frame(self, raw: bytes, rx_ns: int) -> None:
        try:
            version, bundle, pub_ns = unpack_model_frame_ex(raw)
        except Exception as e:
            swallow_decode_error("zmq", "model_listener", e)
            return
        self._m["model_recv_bytes"].inc(len(raw))
        bundle = self._reasm.feed(bundle)
        if bundle is None:
            return  # mid-chunk: the receipt stamps on the last part
        self._ledger.append(version, rx_ns)
        self._m["model_recv_total"].inc()
        if pub_ns is not None and 0 <= rx_ns - pub_ns < int(300e9):
            # Same-host monotonic pair only. CLOCK_MONOTONIC is
            # per-boot, so a cross-host pair is off by the uptime
            # difference in EITHER direction — the negative half is
            # obvious, but the positive half would pin every sample
            # in the +Inf bucket. Anything beyond 300s cannot be a
            # real fan-out latency on this plane; treat it as skew
            # and drop the sample.
            self._m["receipt_latency_seconds"].observe(
                (rx_ns - pub_ns) / 1e9)
        self.on_model(version, bundle)
        self._m["model_deliver_seconds"].observe(
            (time.monotonic_ns() - rx_ns) / 1e9)
        # Downstream trace: the receipt hop (receipt stamp to swap
        # applied) and the actor-side model-age observation off the
        # publisher's monotonic stamp (same skew guard as above).
        from relayrl_tpu_torch.telemetry.trace import record_model_receipt

        record_model_receipt(version, rx_ns, pub_ns, "zmq")

    def _drain_monitor(self) -> None:
        """Process queued PUSH-socket monitor events (model-listener
        thread): a CONNECTED following a DISCONNECTED is a healed
        trajectory pipe — the replay-on-reconnect trigger for this
        backend, which otherwise has no failure signal at all (PUSH
        sends never error; libzmq re-queues silently)."""
        mon = self._push_monitor
        if mon is None:
            return
        try:
            from zmq.utils.monitor import recv_monitor_message

            while mon.poll(0):
                evt = recv_monitor_message(mon)["event"]
                if evt == zmq.EVENT_DISCONNECTED:
                    self._push_broken = True
                elif evt == zmq.EVENT_CONNECTED and self._push_broken:
                    self._push_broken = False
                    self._notify_reconnect()
        except (zmq.ZMQError, KeyError, OSError):
            pass  # monitor died (socket rebuilt): detection degrades

    def drain_receipts(self, max_n: int = 65536) -> list[tuple[int, int]]:
        """Drain the pre-decode receipt ledger: ``[(version,
        rx_mono_ns), ...]`` — same surface and semantics as the native
        C++ ledger (``rl_sub_receipts``), so soak fan-out accounting is
        backend-uniform."""
        return self._ledger.drain(max_n)

    # Resync-request floor: a decoder stuck awaiting a keyframe raises
    # WireBaseMismatch once, but repeated divergences (chaos drills,
    # relay failover) must not turn into a request storm on the ROUTER.
    _RESYNC_MIN_INTERVAL_S = 1.0
    _last_resync_req = 0.0

    def request_resync(self, held_version: int = -1) -> None:
        """Broadcast-plane resync: one CMD_RESYNC
        on the DEALER asks the publisher to make its next publish a
        keyframe (root: coalesced force_keyframe; relay: cached-keyframe
        serve or upstream escalation, decided on ``held_version``) — the
        blackout bound drops from ``<= keyframe_interval`` publishes to
        <= 1. Fire-and-forget and client-side rate-limited; runs on the
        model-listener thread, so the dealer lock hold is a single
        send."""
        now = time.monotonic()
        if now - self._last_resync_req < self._RESYNC_MIN_INTERVAL_S:
            return
        self._last_resync_req = now
        try:
            with self._dealer_lock:
                self._dealer.send_multipart(
                    [CMD_RESYNC, str(int(held_version)).encode()],
                    zmq.DONTWAIT)
        except zmq.ZMQError:
            pass  # full pipe / closing socket: the keyframe cadence heals

    def close(self, drain_s: float = 0.0) -> None:
        """Close every socket. ``drain_s`` > 0 waits up to that long for
        the frames already handed to ``send_trajectory`` to leave (the
        PUSH socket's linger, waited out by terming this transport's own
        context); at 0 they are dropped, as the reference's close does."""
        self._stop.set()
        if self._listener is not None:
            self._listener.join(timeout=5)
            self._listener = None
        for sock in (self._dealer, self._sub, self._push_monitor):
            if sock is not None:
                sock.close(linger=0)
        with self._push_lock:
            self._push.close(linger=max(0, int(drain_s * 1000)))
        self._sub = None
        self._push_monitor = None
        if not self._ctx.closed:
            self._ctx.term()
