"""The relay node: one hop of the hierarchical distribution tree.

Counterpart of :mod:`relayrl_tpu.relay.node`. A :class:`RelayNode` stands
between the training server (or a parent relay) and an actor subtree and
turns BOTH planes into a tree:

**Downstream (model wire).** The relay subscribes ONCE upstream through
a normal agent transport and re-publishes every delivered frame
VERBATIM on its own fan-out plane (zmq PUB, or a grpc long-poll plane)
— so the root publisher pays O(relays) streams per publish instead of
O(actors). Wire-v2 frames are treated as opaque-but-versioned: the CRC
is re-verified per hop (a corrupt frame dies here, never reaches the
subtree), chunked keyframes are reassembled by the upstream listener
before this node sees them (and re-chunked per the downstream plane's
own ``transport.chunk_bytes``), keyframes and v1 bundles are cached,
and deltas pass straight through. A subtree resync (CMD_RESYNC from an
actor whose delta base diverged) is served from the cached keyframe
without ever reaching the root; only a relay whose own cache is cold
escalates upstream.

**Upstream (trajectory wire).** The same node ingests the subtree's
trajectory envelopes — columnar RLD1 frames and per-record payloads
alike, both opaque bytes here — and batch-forwards them upstream over
ONE connection, with every leaf agent's id + ``#s`` seq tag carried
verbatim (``transport.base`` batch containers; the server's ingest
funnel splits them back into per-agent envelopes). The relay runs its
own :class:`~relayrl_tpu_torch.runtime.spool.TrajectorySpool` on behalf of
the subtree, retaining forwards as VERBATIM entries (no relay-level seq
space — a restarted relay minting fresh seqs would be deduplicated into
silence), so a relay crash is the learner crash drill one level up:
spool replay on reconnect + the root ledger's per-leaf dedup ⇒ zero
loss, zero double-train.

**Tracing and fleet telemetry.** With ``telemetry.trace_sample_rate > 0``
the relay records the ``relay`` hop of every sampled trajectory it
forwards (the context rides the leaf's envelope id verbatim) and the
``relay`` re-broadcast span of every sampled model version. With
``telemetry.fleet_interval_s > 0`` subtree snapshot frames peel off into a
fan-in buffer and go upstream as ONE frame per interval, with this relay's
own section; with the plane off they forward verbatim like any payload.

On the wire a relay is indistinguishable from a training server:
actors point their ordinary transport config at the relay's fan-out
addresses. Start one with ``python -m relayrl_tpu_torch.relay``.
"""

from __future__ import annotations

import os
import threading
import time

from relayrl_tpu_torch.config import ConfigLoader


class RelayNode:
    """One relay hop. ``config`` carries the ``relay.*`` section
    (knob-by-knob ctor overrides win); ``upstream_transport`` /
    ``downstream_transport`` are test seams that skip transport
    construction entirely."""

    def __init__(
        self,
        config_path: str | None = None,
        name: str | None = None,
        upstream_type: str | None = None,
        upstream: dict | None = None,
        downstream_type: str | None = None,
        downstream: dict | None = None,
        fanout_port: int | None = None,
        keyframe_cache: bool | None = None,
        batch_max: int | None = None,
        batch_linger_ms: float | None = None,
        spool_entries: int | None = None,
        spool_bytes: int | None = None,
        spool_dir: str | None = None,
        resync_min_interval_s: float | None = None,
        handshake_timeout_s: float = 60.0,
        start: bool = True,
        upstream_transport=None,
        downstream_transport=None,
    ):
        from relayrl_tpu_torch import faults, telemetry

        self.config = ConfigLoader(None, config_path)
        telemetry.configure_from_config(self.config)
        faults.maybe_install_from_env()
        params = self.config.get_relay_params()

        def pick(value, key):
            return params[key] if value is None else value

        self.name = pick(name, "name") or f"relay-{os.getpid()}"
        self.upstream_type = pick(upstream_type, "upstream_type")
        self.downstream_type = pick(downstream_type, "downstream_type")
        self._upstream_overrides = dict(pick(upstream, "upstream"))
        self._downstream_overrides = dict(pick(downstream, "downstream"))
        self._fanout_port = int(pick(fanout_port, "fanout_port"))
        self.keyframe_cache_enabled = bool(pick(keyframe_cache,
                                                "keyframe_cache"))
        self.batch_max = max(1, int(pick(batch_max, "batch_max")))
        self.batch_linger_s = float(pick(batch_linger_ms,
                                         "batch_linger_ms")) / 1000.0
        self._spool_entries = int(pick(spool_entries, "spool_entries"))
        self._spool_bytes = int(pick(spool_bytes, "spool_bytes"))
        self._spool_dir = pick(spool_dir, "spool_dir")
        self.resync_min_interval_s = float(pick(resync_min_interval_s,
                                                "resync_min_interval_s"))
        self._handshake_timeout_s = float(handshake_timeout_s)
        # Upstream wire id for multi-envelope containers: untagged on
        # purpose (see spool.send_verbatim — only LEAF seq tags dedup).
        self.batch_id = f"@relay/{self.name}"

        # -- model cache (one lock guards all three slots) --
        self._model_lock = threading.Lock()
        self._handshake: tuple[int, bytes] | None = None  # v1 bundle
        self._keyframe: tuple[int, bytes] | None = None   # verbatim frame
        self._latest: tuple[int, bytes, int | None] | None = None
        self._latest_version = -1
        self._last_handshake_refresh = -1e9
        self._last_resync_serve = -1e9

        # -- subtree registry (bounded: ids only, for the gauge) --
        self._subtree_lock = threading.Lock()
        self._subtree_agents: set[str] = set()

        # -- forward buffer (downstream ingest -> upstream batches) --
        self._fwd_cond = threading.Condition()
        self._fwd_buf: list[tuple[str, bytes]] = []  # (tagged_id, payload)
        self._fwd_thread: threading.Thread | None = None
        self._stop = threading.Event()

        # -- fault plane (relay hook sites; None without a plan) --
        self._fault_model = faults.site("relay.model")
        self._fault_forward = faults.site("relay.forward")
        self._fault_step = faults.site("relay.step")

        # -- telemetry --
        reg = telemetry.get_registry()
        self._m_fwd_model = reg.counter(
            "relayrl_relay_frames_forwarded_total",
            "frames re-published/forwarded by this relay",
            {"plane": "model"})
        self._m_fwd_traj = reg.counter(
            "relayrl_relay_frames_forwarded_total",
            "frames re-published/forwarded by this relay",
            {"plane": "trajectory"})
        self._m_bytes_model = reg.counter(
            "relayrl_relay_bytes_total",
            "bytes re-published/forwarded by this relay",
            {"plane": "model"})
        self._m_bytes_traj = reg.counter(
            "relayrl_relay_bytes_total",
            "bytes re-published/forwarded by this relay",
            {"plane": "trajectory"})
        self._m_cache_hits = reg.counter(
            "relayrl_relay_keyframe_cache_hits_total",
            "downstream deliveries served from the relay keyframe cache")
        self._m_resyncs = reg.counter(
            "relayrl_relay_resyncs_served_total",
            "subtree resyncs answered by this relay (never reached root)")
        self._m_resync_escalated = reg.counter(
            "relayrl_relay_resyncs_escalated_total",
            "subtree resyncs forwarded upstream (cold/disabled cache)")
        self._m_dropped = reg.counter(
            "relayrl_relay_frames_dropped_total",
            "frames refused at this hop (CRC mismatch / undecodable)")
        self._m_batches = reg.counter(
            "relayrl_relay_batches_forwarded_total",
            "multi-envelope containers sent upstream")
        self._m_fwd_fleet = reg.counter(
            "relayrl_relay_frames_forwarded_total",
            "frames re-published/forwarded by this relay",
            {"plane": "fleet"})
        self._m_bytes_fleet = reg.counter(
            "relayrl_relay_bytes_total",
            "bytes re-published/forwarded by this relay",
            {"plane": "fleet"})
        reg.gauge_fn("relayrl_relay_subtree_agents",
                     self._subtree_count,
                     "distinct logical agents seen from this subtree")

        # Fleet telemetry fan-in (telemetry/aggregate.py): subtree
        # snapshot frames are sniffed out of the trajectory ingest,
        # buffered latest-per-proc, and forwarded as ONE multi-proc frame
        # (plus this relay's own section) per telemetry.fleet_interval_s:
        # root ingest stays O(relays), like the model plane. Interval 0 =
        # plane off: frames fall through the forward path verbatim.
        tel_params = self.config.get_telemetry_params()
        self._fleet_interval_s = float(tel_params.get("fleet_interval_s")
                                       or 0.0)
        self._fleet_buf = None
        self._fleet_seq = 0
        self._fleet_thread: threading.Thread | None = None
        if self._fleet_interval_s > 0:
            from relayrl_tpu_torch.telemetry.aggregate import (
                FleetRelayBuffer,
            )

            self._fleet_buf = FleetRelayBuffer()

        self.spool = None
        self.up = upstream_transport
        self.down = downstream_transport
        self.active = False
        if start:
            self.enable_relay()

    # -- lifecycle --
    def enable_relay(self) -> None:
        if self.active:
            return
        if self.up is None:
            from relayrl_tpu_torch.transport import make_agent_transport

            overrides = dict(self._upstream_overrides)
            overrides.setdefault("identity", self.batch_id)
            self.up = make_agent_transport(self.upstream_type, self.config,
                                           **overrides)
        # Handshake FIRST: the downstream plane must never come up with
        # nothing to serve (an actor's fetch_model would get b"").
        version, bundle = self.up.fetch_model(self._handshake_timeout_s)
        with self._model_lock:
            self._handshake = (int(version), bundle)
            self._keyframe = (int(version), bundle)  # v1 IS a keyframe
            self._latest = (int(version), bundle, None)
            self._latest_version = int(version)
        self.up.register(self.up.identity)
        self._bind_spool()
        if self.down is None:
            self.down = self._build_downstream()
        self.down.get_model = self._get_model
        self.down.get_model_update = self._get_model_update
        self.down.get_model_version = lambda: self._latest_version
        self.down.on_trajectory = self._on_subtree_trajectory
        self.down.on_register = self._on_subtree_register
        self.down.on_unregister = self._on_subtree_unregister
        self.down.on_resync = self._serve_subtree_resync
        self.down.start()
        self._stop.clear()
        if self.batch_max > 1:
            self._fwd_thread = threading.Thread(
                target=self._forward_loop, name="relay-forward", daemon=True)
            self._fwd_thread.start()
        self.up.on_model = self._on_upstream_model
        self.up.on_reconnect = self._on_upstream_reconnect
        self.up.start_model_listener()
        if self._fleet_buf is not None:
            self._fleet_thread = threading.Thread(
                target=self._fleet_loop, name="relay-fleet", daemon=True)
            self._fleet_thread.start()
        self.active = True
        from relayrl_tpu_torch import telemetry

        telemetry.emit("relay_up", name=self.name, version=version,
                       upstream=self.upstream_type,
                       downstream=self.downstream_type)

    def _build_downstream(self):
        cfg = self.config
        over = self._downstream_overrides
        if self.downstream_type == "grpc":
            from relayrl_tpu_torch.transport.grpc_backend import GrpcServerTransport

            bind = over.get("bind_addr")
            if bind is None and self._fanout_port:
                bind = f"0.0.0.0:{self._fanout_port}"
            return GrpcServerTransport(
                bind_addr=bind or cfg.get_train_server().host_port,
                idle_timeout_s=cfg.get_grpc_idle_timeout_s())
        from relayrl_tpu_torch.transport.zmq_backend import ZmqServerTransport

        if self._fanout_port:
            base = self._fanout_port
            defaults = {
                "agent_listener_addr": f"tcp://0.0.0.0:{base}",
                "trajectory_addr": f"tcp://0.0.0.0:{base + 1}",
                "model_pub_addr": f"tcp://0.0.0.0:{base + 2}",
            }
        else:
            defaults = {
                "agent_listener_addr": cfg.get_agent_listener().address,
                "trajectory_addr": cfg.get_traj_server().address,
                "model_pub_addr": cfg.get_train_server().address,
            }
        return ZmqServerTransport(
            agent_listener_addr=over.get("agent_listener_addr",
                                         defaults["agent_listener_addr"]),
            trajectory_addr=over.get("trajectory_addr",
                                     defaults["trajectory_addr"]),
            model_pub_addr=over.get("model_pub_addr",
                                    defaults["model_pub_addr"]),
            chunk_bytes=cfg.get_transport_params()["chunk_bytes"],
        )

    def _bind_spool(self) -> None:
        if self._spool_entries <= 0:
            self.spool = None
            return
        from relayrl_tpu_torch.runtime.spool import TrajectorySpool
        from relayrl_tpu_torch.transport.retry import breaker_from_config

        retry_cfg = self.config.get_transport_params()["retry"]
        if self.spool is None:
            self.spool = TrajectorySpool(
                send_fn=self._wire_forward,
                max_entries=self._spool_entries,
                max_bytes=self._spool_bytes,
                directory=self._spool_dir,
                name=f"relay-{self.name}",
                breaker=breaker_from_config(f"relay:{self.name}", retry_cfg))
            if self._spool_dir and self.spool.depth:
                # A prior relay life left subtree forwards in flight
                # (the relay crash drill): replay them now — leaf seq
                # tags ride verbatim, the root ledger dedups.
                self.spool.replay()
        else:
            self.spool.send_fn = self._wire_forward

    def close(self, flush_timeout_s: float = 10.0) -> None:
        if not self.active:
            return
        self._stop.set()
        # Downstream FIRST: stop() joins the ingest threads, so no new
        # subtree envelope can arrive after this line — everything
        # already delivered sits in the forward buffer or the spool,
        # and the flush below is genuinely final (an envelope landing
        # in a closed spool would get one unretained wire attempt,
        # exactly the loss the spool exists to prevent).
        if self.down is not None:
            self.down.stop()
        with self._fwd_cond:
            self._fwd_cond.notify_all()
        if self._fwd_thread is not None:
            self._fwd_thread.join(timeout=5)
            self._fwd_thread = None
        fleet_final = self._fleet_thread is not None
        if fleet_final:
            self._fleet_thread.join(timeout=5)
            self._fleet_thread = None
        self._drain_forward_buffer()
        if self.spool is not None:
            if flush_timeout_s > 0:
                self.spool.flush(deadline_s=flush_timeout_s)
            self.spool.close()
        if fleet_final:
            # Final flush, after the spool's: whatever the subtree
            # reported last, plus this relay's closing section with its
            # last forwards and replays counted, still reaches the root.
            self._fleet_flush()
        if self.up is not None:
            # The final frame must leave before the socket goes: a zmq
            # send only queues it.
            from relayrl_tpu_torch.telemetry.aggregate import FLEET_DRAIN_S

            self.up.close(drain_s=FLEET_DRAIN_S if fleet_final else 0.0)
        self.active = False

    # -- model plane (upstream subscription -> downstream fan-out) --
    def _on_upstream_model(self, version: int, blob: bytes) -> None:
        """One upstream delivery (upstream listener thread): per-hop
        verify, cache, re-broadcast VERBATIM. Chunked frames never reach
        here — the upstream agent transport's listener reassembles
        before ``on_model`` fires — and the downstream plane re-chunks
        per its own ``transport.chunk_bytes``. Isolated like the actor's
        ``_deliver_model``: the transports call ``on_model`` unguarded,
        so ANY escape here would kill the listener thread and silently
        freeze model distribution for the whole subtree."""
        try:
            self._handle_upstream_model(version, blob)
        except Exception as e:
            self._m_dropped.inc()
            print(f"[relay/{self.name}] model delivery failed "
                  f"(frame dropped): {e!r}", flush=True)

    def _handle_upstream_model(self, version: int, blob: bytes) -> None:
        from relayrl_tpu_torch.transport.modelwire import (
            KIND_CHUNK,
            KIND_KEYFRAME,
            WireFrameError,
            is_wire_frame,
            verify_frame,
        )

        base: int | None = None
        keyframe_like = True
        if is_wire_frame(blob):
            try:
                kind, version, base = verify_frame(blob)
            except WireFrameError as e:
                # Corrupt at THIS hop: never re-broadcast rot to the
                # subtree; ask upstream for a keyframe instead.
                self._m_dropped.inc()
                print(f"[relay/{self.name}] dropped corrupt model frame: "
                      f"{e}", flush=True)
                self.up.request_resync()
                return
            if kind == KIND_CHUNK:  # listener contract violation
                self._m_dropped.inc()
                return
            keyframe_like = kind == KIND_KEYFRAME
        with self._model_lock:
            if version <= self._latest_version:
                return  # stale/duplicate delivery: never rebroadcast
            if keyframe_like:
                if is_wire_frame(blob):
                    self._keyframe = (int(version), blob)
                else:
                    # v1 full bundle: doubles as the handshake model.
                    self._handshake = (int(version), blob)
                    self._keyframe = (int(version), blob)
            self._latest = (int(version), blob, base)
            self._latest_version = int(version)
        self._rebroadcast(version, blob)

    def _rebroadcast(self, version: int, blob: bytes) -> None:
        from relayrl_tpu_torch.telemetry import trace as trace_mod

        tracer = trace_mod.get_tracer()
        traced = tracer.enabled and tracer.sample_version(version)
        t0_ns = time.monotonic_ns() if traced else 0
        parts = (((0.0, blob),) if self._fault_model is None
                 else self._fault_model.inject(blob))
        for delay_s, part in parts:
            if delay_s > 0:
                time.sleep(delay_s)
            try:
                self.down.publish_model(int(version), part)
            except Exception as e:
                print(f"[relay/{self.name}] downstream publish failed: "
                      f"{e!r}", flush=True)
                return
            self._m_fwd_model.inc()
            self._m_bytes_model.inc(len(part))
        if traced:
            # The re-broadcast hop of a sampled version's downstream
            # trace: the upstream receipt is stamped by the agent
            # transport; this span is the subtree fan-out itself.
            tracer.span("model", trace_mod.model_trace_id(version),
                        "relay", t0_ns, time.monotonic_ns(),
                        version=int(version), relay=self.name)

    def _get_model(self) -> tuple[int, bytes]:
        """Downstream handshake: the cached v1 bundle. When the relay
        has seen newer wire frames than the bundle it holds, refresh it
        from upstream (rate-limited — one root round-trip per window,
        shared by every joiner in the subtree); a refresh failure serves
        the older bundle, and the joiner catches up through the normal
        delta/resync path."""
        with self._model_lock:
            hv, hb = self._handshake
            stale = self._latest_version > hv
            due = (time.monotonic() - self._last_handshake_refresh) >= 2.0
            if stale and due:
                self._last_handshake_refresh = time.monotonic()
            else:
                stale = False
        if stale:
            try:
                version, bundle = self.up.fetch_model(timeout_s=10.0)
                with self._model_lock:
                    if version > self._handshake[0]:
                        self._handshake = (int(version), bundle)
                    hv, hb = self._handshake
            except Exception as e:
                print(f"[relay/{self.name}] handshake refresh failed "
                      f"({e!r}) — serving cached v{hv}", flush=True)
        else:
            self._m_cache_hits.inc()
        return hv, hb

    def _get_model_update(self, known_version: int) -> tuple[int, bytes]:
        """Downstream pull surface (grpc long-polls): the latest frame
        when the subscriber can decode it, else the cached keyframe
        (the subtree resync that never touches the root), else the
        handshake bundle. NEVER a blob older than ``known_version`` —
        the poll client adopts the reply's version, so a stale bundle
        would REGRESS the subscriber and re-arm its poll in a hot loop.
        When only the undecodable latest delta is newer, serve it: the
        subscriber's decoder raises a base mismatch, its explicit
        ``ver=-1`` resync re-polls, and by then the rate-limited
        handshake refresh has a current bundle."""
        with self._model_lock:
            latest = self._latest
            keyframe = self._keyframe
        if latest is not None:
            version, blob, base = latest
            if version > known_version and (base is None
                                            or base == known_version):
                return version, blob
        if (self.keyframe_cache_enabled and keyframe is not None
                and keyframe[0] > known_version):
            self._m_cache_hits.inc()
            self._m_resyncs.inc()
            return keyframe
        hv, hb = self._get_model()
        if hv > known_version or latest is None \
                or latest[0] <= known_version:
            return hv, hb
        return latest[0], latest[1]

    def _serve_subtree_resync(self, held_version: int = -1) -> None:
        """CMD_RESYNC from the subtree (downstream ROUTER thread),
        decided on the requester's held version:

        * held BELOW the cached keyframe (late joiner, long blackout):
          re-broadcast the cache — rate-limited, one re-broadcast per
          window no matter how many lanes diverged; healthy actors drop
          it as stale, the diverged ones reseed. The root is never
          touched.
        * held AT/ABOVE the cache (mid-stream divergence): the cache
          CANNOT heal it — decoders drop versions at or below their
          own — so escalate upstream (the root's forced keyframe, or a
          parent relay's same decision), rate-limited by the upstream
          transport's own request floor.
        * held unknown (-1): do both — the cache serve is free for any
          lane it can help, the escalation guarantees the heal."""
        with self._model_lock:
            keyframe = (self._keyframe if self.keyframe_cache_enabled
                        else None)
            serve = (keyframe is not None
                     and (held_version < 0 or keyframe[0] > held_version))
            escalate = (keyframe is None or held_version < 0
                        or keyframe[0] <= held_version)
            if serve:
                now = time.monotonic()
                if now - self._last_resync_serve < self.resync_min_interval_s:
                    serve = False  # coalesced into the window's serve
                else:
                    self._last_resync_serve = now
        if serve:
            self._m_resyncs.inc()
            self._m_cache_hits.inc()
            self._rebroadcast(keyframe[0], keyframe[1])
        if escalate:
            self._m_resync_escalated.inc()
            self.up.request_resync(held_version)

    # -- fleet telemetry plane (subtree frames -> one merged frame) --
    def _fleet_loop(self) -> None:
        while not self._stop.wait(self._fleet_interval_s):
            self._fleet_flush()

    def _fleet_flush(self) -> None:
        """One fan-in interval: the sections the subtree updated since the
        last flush plus this relay's own registry section, forwarded
        upstream as ONE frame. Sections ride VERBATIM (the root's
        epoch-aware counter baselines need the leaf's own stamps).
        Spool-less on purpose: telemetry is latest-wins, and replaying a
        retained stale snapshot would regress the root's table."""
        from relayrl_tpu_torch import telemetry
        from relayrl_tpu_torch.telemetry.aggregate import (
            encode_snapshot_frame,
            fleet_wire_id,
            snapshot_section,
        )

        sections = self._fleet_buf.drain()
        reg = telemetry.get_registry()
        if reg.enabled:
            self._fleet_seq += 1
            sections.append(snapshot_section(
                reg.snapshot(), self.name, "relay",
                getattr(reg, "created_unix", 0.0), self._fleet_seq))
        if not sections:
            return
        frame = encode_snapshot_frame(sections)
        try:
            self.up.send_trajectory(frame,
                                    agent_id=fleet_wire_id(self.name))
        except Exception as e:
            print(f"[relay/{self.name}] fleet forward failed (dropped; "
                  f"next interval is fresher anyway): {e!r}", flush=True)
            return
        self._m_fwd_fleet.inc()
        self._m_bytes_fleet.inc(len(frame))

    def _ingest_subtree_snapshot(self, payload: bytes) -> None:
        from relayrl_tpu_torch.transport.base import swallow_decode_error

        try:
            self._fleet_buf.ingest_frame(payload)
        except ValueError as e:
            self._m_dropped.inc()
            swallow_decode_error(self.downstream_type, "fleet_frame", e)

    # -- trajectory plane (downstream ingest -> upstream forward) --
    def _on_subtree_trajectory(self, tagged_id: str, payload: bytes) -> None:
        """One subtree envelope (downstream transport thread). The id
        arrives with the leaf's seq tag intact and MUST leave with it
        intact — attribution and dedup belong to the leaves. Fleet
        snapshot frames (RLS1) peel off into the fan-in buffer instead of
        the forward path; with the fleet plane off they forward verbatim
        like any other opaque payload."""
        from relayrl_tpu_torch.telemetry.aggregate import is_snapshot_frame

        if self._fleet_buf is not None and is_snapshot_frame(payload):
            self._ingest_subtree_snapshot(payload)
            return
        from relayrl_tpu_torch.transport.base import (
            split_agent_seq,
            split_agent_trace,
        )

        clean_id, _seq = split_agent_seq(tagged_id)
        clean_id, _trace = split_agent_trace(clean_id)
        with self._subtree_lock:
            if len(self._subtree_agents) < 65536:
                self._subtree_agents.add(clean_id)
        if self.batch_max <= 1:
            self._forward_one(tagged_id, payload)
            return
        with self._fwd_cond:
            self._fwd_buf.append((tagged_id, payload))
            self._fwd_cond.notify_all()

    def _forward_loop(self) -> None:
        """Dedicated forwarder: drains the ingest buffer into upstream
        sends, coalescing up to ``batch_max`` envelopes per send after a
        ``batch_linger_ms`` wait for siblings — the same shave the
        anakin hosts' ``actor.emit_coalesce_frames`` applies at the
        leaf, one level up."""
        while True:
            with self._fwd_cond:
                while not self._fwd_buf and not self._stop.is_set():
                    self._fwd_cond.wait(0.2)
                if self._stop.is_set() and not self._fwd_buf:
                    return
                if (len(self._fwd_buf) < self.batch_max
                        and self.batch_linger_s > 0
                        and not self._stop.is_set()):
                    deadline = time.monotonic() + self.batch_linger_s
                    while (len(self._fwd_buf) < self.batch_max
                           and not self._stop.is_set()):
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._fwd_cond.wait(remaining)
                group = self._fwd_buf[:self.batch_max]
                del self._fwd_buf[:self.batch_max]
            self._flush_group(group)

    def _drain_forward_buffer(self) -> None:
        while True:
            with self._fwd_cond:
                group = self._fwd_buf[:self.batch_max]
                del self._fwd_buf[:self.batch_max]
            if not group:
                return
            self._flush_group(group)

    def _flush_group(self, group: list[tuple[str, bytes]]) -> None:
        from relayrl_tpu_torch.transport.base import (
            BATCH_KIND_ENVELOPES,
            pack_batch,
            pack_trajectory_envelope,
        )

        if not group:
            return
        if len(group) == 1:
            self._forward_one(*group[0])
            return
        container = pack_batch(
            BATCH_KIND_ENVELOPES,
            [pack_trajectory_envelope(tid, payload)
             for tid, payload in group])
        self._m_batches.inc()
        self._m_fwd_traj.inc(len(group))
        self._m_bytes_traj.inc(len(container))
        t0_ns = time.monotonic_ns()
        if self.spool is not None:
            self.spool.send_verbatim(container, self.batch_id)
        else:
            self._try_forward(container, self.batch_id)
        for tid, _payload in group:
            self._trace_forward_span(tid, t0_ns)

    def _trace_forward_span(self, tagged_id: str, t0_ns: int) -> None:
        """Upstream-trace relay hop: a sampled trajectory's context rides
        the forwarded envelope id verbatim; peel it (without touching the
        wire id) and record this hop's forward time."""
        from relayrl_tpu_torch.telemetry import trace as trace_mod
        from relayrl_tpu_torch.transport.base import split_agent_seq

        tracer = trace_mod.get_tracer()
        if not tracer.enabled:
            return
        base, _seq = split_agent_seq(tagged_id)
        _clean, ctx = trace_mod.split_ctx(base)
        if ctx is None:
            return
        tracer.span("traj", ctx.trace_id, "relay", t0_ns,
                    time.monotonic_ns(), relay=self.name)

    def _forward_one(self, tagged_id: str, payload: bytes) -> None:
        self._m_fwd_traj.inc()
        self._m_bytes_traj.inc(len(payload))
        t0_ns = time.monotonic_ns()
        if self.spool is not None:
            self.spool.send_verbatim(payload, tagged_id)
        else:
            self._try_forward(payload, tagged_id)
        self._trace_forward_span(tagged_id, t0_ns)

    def _try_forward(self, payload: bytes, wire_id: str) -> None:
        """Spool-less direct forward: drop on failure, never crash the
        ingest thread (the spooled path owns retention + replay)."""
        try:
            self._wire_forward(payload, wire_id)
        except Exception as e:
            self._m_dropped.inc()
            print(f"[relay/{self.name}] upstream forward failed "
                  f"(no spool): {e!r}", flush=True)

    def _wire_forward(self, payload: bytes, wire_id: str) -> None:
        """One upstream wire attempt (the spool's send_fn) through the
        ``relay.forward`` fault site."""
        if self._fault_forward is None:
            self.up.send_trajectory(payload, agent_id=wire_id)
            return
        for delay_s, part in self._fault_forward.inject(payload):
            if delay_s > 0:
                time.sleep(delay_s)
            self.up.send_trajectory(part, agent_id=wire_id)

    # -- registry plane --
    def _on_subtree_register(self, agent_id: str) -> None:
        with self._subtree_lock:
            if len(self._subtree_agents) < 65536:
                self._subtree_agents.add(agent_id)
        # Forward so the ROOT registry still sees every logical agent
        # (best-effort: registration is observability, not correctness).
        try:
            self.up.register(agent_id, timeout_s=5.0)
        except Exception as e:
            print(f"[relay/{self.name}] upstream register {agent_id!r} "
                  f"failed: {e!r}", flush=True)

    def _on_subtree_unregister(self, agent_id: str) -> None:
        with self._subtree_lock:
            self._subtree_agents.discard(agent_id)

    def _subtree_count(self) -> int:
        with self._subtree_lock:
            return len(self._subtree_agents)

    def _on_upstream_reconnect(self) -> None:
        """Upstream heal (transport thread): re-register and replay the
        retained subtree window — leaf tags verbatim, root dedup makes
        it exactly-once: the agents' reconnect contract, one level up."""
        from relayrl_tpu_torch import telemetry

        try:
            self.up.register(self.up.identity, timeout_s=5.0)
        except Exception:
            pass
        replayed = self.spool.replay() if self.spool is not None else 0
        telemetry.emit("relay_reconnect", name=self.name,
                       replayed=replayed)

    # -- operator surface --
    def stats(self) -> dict:
        return {
            "name": self.name,
            "latest_version": self._latest_version,
            "handshake_version": (self._handshake[0]
                                  if self._handshake else -1),
            "keyframe_version": (self._keyframe[0]
                                 if self._keyframe else -1),
            "subtree_agents": self._subtree_count(),
            "model_frames_forwarded": self._m_fwd_model.total(),
            "trajectory_frames_forwarded": self._m_fwd_traj.total(),
            "resyncs_served": self._m_resyncs.total(),
            "keyframe_cache_hits": self._m_cache_hits.total(),
            "frames_dropped": self._m_dropped.total(),
            "spool_depth": self.spool.depth if self.spool else 0,
        }

    def run(self, duration_s: float | None = None,
            stop_file: str | None = None, poll_s: float = 0.25) -> None:
        """Foreground loop for the ``python -m relayrl_tpu_torch.relay``
        entrypoint: idles while the transport threads relay, honoring
        the ``relay.step`` kill_process site (the relay crash drill)
        and the stop conditions."""
        deadline = (None if duration_s is None
                    else time.monotonic() + duration_s)
        while not self._stop.is_set():
            if self._fault_step is not None \
                    and self._fault_step.take_kill_process():
                import signal

                os.kill(os.getpid(), signal.SIGKILL)
            if deadline is not None and time.monotonic() >= deadline:
                return
            if stop_file is not None and os.path.exists(stop_file):
                return
            time.sleep(poll_s)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


__all__ = ["RelayNode"]
