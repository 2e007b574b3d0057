"""The port's relay tree, following ``tests/test_relay.py``.

* Model plane: frames forward verbatim with a per-hop CRC; keyframes and
  v1 bundles are cached; subtree resyncs are served from the cache or
  escalated; the pull surface never regresses a subscriber.
* Trajectory plane: leaf ids and ``#s`` tags ride verbatim, batched
  forwards split back into per-leaf dedup at the server, the relay spool
  survives a relay's death.
* Live ZMQ: chunked keyframes reassembled before the re-broadcast, a
  wire-base mismatch healed in one publish, the subscriber gauge; the
  server's resync request path.
* The relay SIGKILL drill over ZMQ on ``python -m relayrl_tpu_torch.relay``
  (zero loss, zero double-train, models advance behind the replacement).
* A port relay between a JAX server and a port agent forwards the JAX
  server's frames byte for byte.
* A relay built with ``telemetry.trace_sample_rate`` traces the relay hop
  of a sampled trajectory; one built with ``telemetry.fleet_interval_s``
  peels subtree snapshot frames off the forward path into one merged
  upstream frame.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from tests._util import free_port

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def fresh_registry():
    from relayrl_tpu_torch import telemetry

    registry = telemetry.Registry(run_id="test-relay")
    telemetry.set_registry(registry)
    yield registry
    telemetry.reset_for_tests()


# ---------------------------------------------------------------------------
# fakes (unit-level seams for RelayNode)
# ---------------------------------------------------------------------------

def _make_fakes():
    from relayrl_tpu_torch.transport.base import AgentTransport, ServerTransport

    class FakeUpstream(AgentTransport):
        def __init__(self, handshake=(1, b"HANDSHAKE-V1")):
            super().__init__()
            self.handshake = handshake
            self.sent: list[tuple[str, bytes]] = []
            self.registered: list[str] = []
            self.resyncs = 0
            self.fetches = 0
            self.fail_sends = False
            self.identity = "fake-up"

        def fetch_model(self, timeout_s=60.0):
            self.fetches += 1
            return self.handshake

        def register(self, agent_id=None, timeout_s=10.0):
            self.registered.append(agent_id)
            return True

        def send_trajectory(self, payload, agent_id=None):
            if self.fail_sends:
                raise ConnectionError("upstream down (test)")
            self.sent.append((agent_id, payload))

        def start_model_listener(self):
            pass

        def request_resync(self, held_version=-1):
            self.resyncs += 1

        def close(self, drain_s=0.0):
            self.closed_with = drain_s

    class FakeDownstream(ServerTransport):
        def __init__(self):
            super().__init__()
            self.published: list[tuple[int, bytes]] = []
            self.started = False

        def start(self):
            self.started = True

        def stop(self):
            self.started = False

        def publish_model(self, version, bundle_bytes):
            self.published.append((int(version), bundle_bytes))

    return FakeUpstream, FakeDownstream


def _make_node(tmp_cwd, fake_up, fake_down, **kwargs):
    from relayrl_tpu_torch.relay import RelayNode

    kwargs.setdefault("name", "t")
    kwargs.setdefault("batch_max", 1)
    return RelayNode(upstream_transport=fake_up,
                     downstream_transport=fake_down, **kwargs)


def _wire_frames(n_deltas: int = 1, keyframe_interval: int = 100,
                 base_version: int = 2):
    """(keyframe_frame, [delta frames...]) from a real encoder with the
    small-model passthrough disabled (frames, not v1 bundles)."""
    from relayrl_tpu_torch.transport.modelwire import ModelWireEncoder

    enc = ModelWireEncoder(keyframe_interval=keyframe_interval,
                           small_model_bytes=0)
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((64, 8)).astype(np.float32)}
    arch = {"kind": "test"}
    key, _ = enc.encode(base_version, arch, params)
    deltas = []
    for k in range(n_deltas):
        params = {"w": params["w"] + np.float32(1e-3)}
        frame, info = enc.encode(base_version + 1 + k, arch, params)
        assert info["kind"] == "delta"
        deltas.append(frame)
    return key, deltas


# ---------------------------------------------------------------------------
# model plane: verbatim forwarding, per-hop CRC, cache, resync serving
# ---------------------------------------------------------------------------

class TestRelayModelPlane:
    def test_frames_forward_verbatim_bytes_in_bytes_out(self, tmp_cwd,
                                                        fresh_registry):
        FakeUpstream, FakeDownstream = _make_fakes()
        up, down = FakeUpstream(), FakeDownstream()
        node = _make_node(tmp_cwd, up, down)
        key, (delta,) = _wire_frames(n_deltas=1)
        node._on_upstream_model(2, key)
        node._on_upstream_model(3, delta)
        assert down.published == [(2, key), (3, delta)]
        # bytes out ARE bytes in — not equal-length, IDENTICAL
        assert down.published[0][1] is key or down.published[0][1] == key
        assert down.published[1][1] == delta
        # keyframe cached; delta passed through without touching it
        assert node._keyframe == (2, key)
        assert node._latest[0] == 3
        node.close(flush_timeout_s=0)

    def test_corrupt_frame_dies_at_this_hop(self, tmp_cwd, fresh_registry):
        FakeUpstream, FakeDownstream = _make_fakes()
        up, down = FakeUpstream(), FakeDownstream()
        node = _make_node(tmp_cwd, up, down)
        key, (delta,) = _wire_frames(n_deltas=1)
        node._on_upstream_model(2, key)
        corrupt = bytearray(delta)
        corrupt[-1] ^= 0x5A  # payload byte: header parses, CRC fails
        node._on_upstream_model(3, bytes(corrupt))
        # never re-broadcast rot; ask upstream for a keyframe instead
        assert down.published == [(2, key)]
        assert up.resyncs == 1
        assert node.stats()["frames_dropped"] == 1
        node.close(flush_timeout_s=0)

    def test_v1_bundle_updates_handshake_and_keyframe_cache(self, tmp_cwd,
                                                            fresh_registry):
        FakeUpstream, FakeDownstream = _make_fakes()
        up, down = FakeUpstream(), FakeDownstream()
        node = _make_node(tmp_cwd, up, down)
        node._on_upstream_model(5, b"V1-FULL-BUNDLE")
        assert down.published == [(5, b"V1-FULL-BUNDLE")]
        assert node._get_model() == (5, b"V1-FULL-BUNDLE")
        assert node._keyframe == (5, b"V1-FULL-BUNDLE")
        node.close(flush_timeout_s=0)

    def test_stale_delivery_never_rebroadcast(self, tmp_cwd,
                                              fresh_registry):
        FakeUpstream, FakeDownstream = _make_fakes()
        up, down = FakeUpstream(), FakeDownstream()
        node = _make_node(tmp_cwd, up, down)
        key, _ = _wire_frames(n_deltas=0)
        node._on_upstream_model(2, key)
        node._on_upstream_model(2, key)  # duplicate delivery
        assert len(down.published) == 1
        node.close(flush_timeout_s=0)

    def test_subtree_resync_served_from_cache_without_root(
            self, tmp_cwd, fresh_registry):
        FakeUpstream, FakeDownstream = _make_fakes()
        up, down = FakeUpstream(), FakeDownstream()
        node = _make_node(tmp_cwd, up, down, resync_min_interval_s=0.2)
        key, _ = _wire_frames(n_deltas=0)
        node._on_upstream_model(2, key)
        # late joiner (held 0 < cached keyframe 2): serve locally
        node._serve_subtree_resync(0)
        assert down.published[-1] == (2, key)
        assert node.stats()["resyncs_served"] == 1
        assert up.resyncs == 0  # never reached the root
        # a storm coalesces into the rate-limit window
        node._serve_subtree_resync(0)
        assert node.stats()["resyncs_served"] == 1
        node.close(flush_timeout_s=0)

    def test_midstream_divergence_escalates_past_stale_cache(
            self, tmp_cwd, fresh_registry):
        """A subscriber NEWER than the cached keyframe cannot be healed
        by it (decoders drop stale versions) — the relay must escalate
        to the root's force_keyframe instead of serving a useless
        re-broadcast forever."""
        FakeUpstream, FakeDownstream = _make_fakes()
        up, down = FakeUpstream(), FakeDownstream()
        node = _make_node(tmp_cwd, up, down)
        key, _ = _wire_frames(n_deltas=0)
        node._on_upstream_model(2, key)
        published_before = len(down.published)
        node._serve_subtree_resync(150)  # held >= cache version
        assert up.resyncs == 1           # escalated upstream
        assert len(down.published) == published_before  # no stale serve
        # unknown held: both — the cache serve is free, the escalation
        # guarantees the heal
        node._serve_subtree_resync(-1)
        assert up.resyncs == 2
        assert down.published[-1] == (2, key)
        node.close(flush_timeout_s=0)

    def test_cold_cache_resync_escalates_upstream(self, tmp_cwd,
                                                  fresh_registry):
        FakeUpstream, FakeDownstream = _make_fakes()
        up, down = FakeUpstream(), FakeDownstream()
        node = _make_node(tmp_cwd, up, down, keyframe_cache=False)
        node._serve_subtree_resync(0)
        assert up.resyncs == 1
        node.close(flush_timeout_s=0)

    def test_pull_surface_serves_latest_then_keyframe(self, tmp_cwd,
                                                      fresh_registry):
        """The grpc long-poll surface: a subscriber whose base matches
        gets the delta verbatim; a diverged one gets the cached
        keyframe (the resync that never touches the root)."""
        FakeUpstream, FakeDownstream = _make_fakes()
        up, down = FakeUpstream(), FakeDownstream()
        node = _make_node(tmp_cwd, up, down)
        key, (delta,) = _wire_frames(n_deltas=1)
        node._on_upstream_model(2, key)
        node._on_upstream_model(3, delta)
        assert node._get_model_update(2) == (3, delta)   # base matches
        assert node._get_model_update(0) == (2, key)     # diverged
        node.close(flush_timeout_s=0)

    def test_pull_surface_never_regresses_a_subscriber(self, tmp_cwd,
                                                       fresh_registry):
        """A poll client adopts the reply's version, so the relay must
        never answer with a blob OLDER than known_version (the stale
        handshake bundle would regress the subscriber into a hot
        stale-bundle loop). With only an undecodable newer delta on
        hand, serve the delta — the subscriber's base mismatch triggers
        its explicit ver=-1 resync."""
        FakeUpstream, FakeDownstream = _make_fakes()
        up, down = FakeUpstream(), FakeDownstream()
        # handshake v1; cached keyframe v2; delta v6 with base 5 — a
        # subscriber at known=4 can decode none of the caches
        node = _make_node(tmp_cwd, up, down)
        key, _ = _wire_frames(n_deltas=0)
        node._on_upstream_model(2, key)
        _, (d6,) = _wire_frames(n_deltas=1, base_version=5)
        node._on_upstream_model(6, d6)
        up.fetches = 0
        version, blob = node._get_model_update(4)
        assert version > 4, "served a blob that would regress the poller"
        assert (version, blob) == (6, d6)  # the mismatch-then-resync path
        node.close(flush_timeout_s=0)

    def test_header_mangled_frame_drops_without_killing_listener(
            self, tmp_cwd, fresh_registry):
        """A frame whose msgpack HEADER is corrupted (payload CRC still
        intact) must die at the hop as a counted drop — any exception
        escaping on_model would kill the upstream listener thread and
        silently freeze the whole subtree's model plane."""
        FakeUpstream, FakeDownstream = _make_fakes()
        up, down = FakeUpstream(), FakeDownstream()
        node = _make_node(tmp_cwd, up, down)
        key, (delta,) = _wire_frames(n_deltas=1)
        node._on_upstream_model(2, key)
        mangled = bytearray(delta)
        mangled[12] ^= 0xFF  # inside the msgpack header region
        node._on_upstream_model(3, bytes(mangled))  # must not raise
        assert down.published == [(2, key)]
        assert node.stats()["frames_dropped"] == 1
        node.close(flush_timeout_s=0)


# ---------------------------------------------------------------------------
# trajectory plane: verbatim ids, batching, spool restore
# ---------------------------------------------------------------------------

class TestRelayTrajectoryPlane:
    def test_single_forward_carries_tag_verbatim(self, tmp_cwd,
                                                 fresh_registry):
        FakeUpstream, FakeDownstream = _make_fakes()
        up, down = FakeUpstream(), FakeDownstream()
        node = _make_node(tmp_cwd, up, down, batch_max=1)
        node._on_subtree_trajectory("leaf-a#s7", b"PAYLOAD")
        assert up.sent == [("leaf-a#s7", b"PAYLOAD")]
        node.close(flush_timeout_s=0)

    def test_batched_forward_keeps_every_leaf_tag(self, tmp_cwd,
                                                  fresh_registry):
        from relayrl_tpu_torch.transport.base import (
            BATCH_KIND_ENVELOPES,
            batch_kind,
            split_batch,
            unpack_trajectory_envelope,
        )

        FakeUpstream, FakeDownstream = _make_fakes()
        up, down = FakeUpstream(), FakeDownstream()
        node = _make_node(tmp_cwd, up, down, batch_max=3,
                          batch_linger_ms=50.0)
        for k in range(3):
            node._on_subtree_trajectory(f"leaf-{k}#s{k + 1}",
                                        f"P{k}".encode())
        deadline = time.monotonic() + 5
        while not up.sent and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(up.sent) == 1
        wire_id, container = up.sent[0]
        assert wire_id == node.batch_id and "#s" not in wire_id
        assert batch_kind(container) == BATCH_KIND_ENVELOPES
        inner = [unpack_trajectory_envelope(p)
                 for p in split_batch(container)]
        assert inner == [(f"leaf-{k}#s{k + 1}", f"P{k}".encode())
                         for k in range(3)]
        node.close(flush_timeout_s=0)

    def test_server_splits_batch_back_to_per_leaf_dedup(self, tmp_cwd,
                                                        fresh_registry):
        """The root half of the batched forward: an envelope batch
        entering the ingest funnel lands as N per-leaf, seq-deduped
        trajectories — relay batching is invisible to accounting."""
        from relayrl_tpu_torch.runtime.server import TrainingServer
        from relayrl_tpu_torch.transport.base import (
            BATCH_KIND_ENVELOPES,
            pack_batch,
            pack_trajectory_envelope,
        )
        from relayrl_tpu_torch.types.trajectory import serialize_actions
        from relayrl_tpu_torch.types.action import ActionRecord

        addrs = {
            "agent_listener_addr": f"tcp://127.0.0.1:{free_port()}",
            "trajectory_addr": f"tcp://127.0.0.1:{free_port()}",
            "model_pub_addr": f"tcp://127.0.0.1:{free_port()}",
        }
        server = TrainingServer(
            "REINFORCE", obs_dim=3, act_dim=2, env_dir=str(tmp_cwd),
            hyperparams={"traj_per_epoch": 100, "hidden_sizes": [8, 8]},
            device="cpu", **addrs)
        try:
            traj = serialize_actions([
                ActionRecord(obs=np.zeros(3, np.float32),
                             act=np.int32(0), rew=1.0),
                ActionRecord(rew=1.0, done=True),
            ])
            envs = [pack_trajectory_envelope(f"leaf-{k}#s1", traj)
                    for k in range(3)]
            container = pack_batch(BATCH_KIND_ENVELOPES, envs)
            server._on_trajectory("@relay/t", container)
            # duplicate batch (a replay): per-leaf dedup eats all of it
            server._on_trajectory("@relay/t", container)
            server.drain(timeout=30)
            acct = server.ingest_accounting()
            assert set(acct["agents"]) == {f"leaf-{k}" for k in range(3)}
            for row in acct["agents"].values():
                assert row == {"max_seq": 1, "accepted": 1,
                               "contiguous": True}
            assert acct["duplicates"] == 3
            assert server.stats["trajectories"] == 3
        finally:
            server.disable_server()

    def test_spool_survives_relay_death_with_tags_verbatim(
            self, tmp_cwd, fresh_registry, tmp_path):
        """File-backed relay spool: a dead-upstream relay retains the
        subtree's forwards on disk; the REPLACEMENT process restores and
        replays them with the original leaf ids untouched."""
        FakeUpstream, FakeDownstream = _make_fakes()
        up, down = FakeUpstream(), FakeDownstream()
        up.fail_sends = True  # upstream dark: everything spools
        spool_dir = str(tmp_path / "relay_spool")
        node = _make_node(tmp_cwd, up, down, batch_max=1,
                          spool_dir=spool_dir)
        for k in range(4):
            node._on_subtree_trajectory(f"leaf#s{k + 1}", f"P{k}".encode())
        assert node.spool.depth == 4
        node.close(flush_timeout_s=0)  # crash stand-in: no flush

        up2, down2 = FakeUpstream(), FakeDownstream()
        node2 = _make_node(tmp_cwd, up2, down2, batch_max=1,
                           spool_dir=spool_dir)
        deadline = time.monotonic() + 5
        while len(up2.sent) < 4 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert up2.sent == [(f"leaf#s{k + 1}", f"P{k}".encode())
                            for k in range(4)]
        node2.close(flush_timeout_s=0)

    def test_verbatim_entries_never_mint_relay_seqs(self, tmp_cwd):
        """send_verbatim retains without a seq space: sent_counts stays
        empty, and the disk sentinel round-trips seq None."""
        from relayrl_tpu_torch.runtime.spool import TrajectorySpool

        sent = []
        spool = TrajectorySpool(
            send_fn=lambda p, tid: sent.append((tid, p)),
            directory=str(tmp_cwd), name="verbatim")
        spool.send_verbatim(b"A", "x#s9")
        spool.send(b"B", "own-lane")
        assert sent == [("x#s9", b"A"), ("own-lane#s1", b"B")]
        assert spool.sent_counts() == {"own-lane": 1}
        spool.close()
        reloaded = TrajectorySpool(send_fn=None, directory=str(tmp_cwd),
                                   name="verbatim")
        assert [(e[0], e[1]) for e in reloaded._entries] == [
            ("x#s9", None), ("own-lane", 1)]
        assert reloaded.next_seq("x#s9") == 1  # no seq space minted
        reloaded.close()


# ---------------------------------------------------------------------------
# chunk reassembly + resync-request path (live zmq)
# ---------------------------------------------------------------------------

class TestRelayZmqIntegration:
    def test_chunked_keyframe_reassembled_before_rebroadcast(
            self, tmp_cwd, fresh_registry):
        """Root splits a large keyframe into chunk frames
        (transport.chunk_bytes); the relay's upstream listener must
        reassemble the ORIGINAL frame before the relay re-broadcasts —
        one whole frame downstream, byte-identical, re-chunked only by
        the relay's own plane (off here)."""
        from relayrl_tpu_torch.transport.zmq_backend import (
            ZmqAgentTransport,
            ZmqServerTransport,
        )

        _FakeUpstream, FakeDownstream = _make_fakes()
        ports = [free_port() for _ in range(3)]
        root = ZmqServerTransport(
            agent_listener_addr=f"tcp://127.0.0.1:{ports[0]}",
            trajectory_addr=f"tcp://127.0.0.1:{ports[1]}",
            model_pub_addr=f"tcp://127.0.0.1:{ports[2]}",
            chunk_bytes=512)
        root.get_model = lambda: (1, b"HS")
        root.start()
        up = ZmqAgentTransport(
            agent_listener_addr=f"tcp://127.0.0.1:{ports[0]}",
            trajectory_addr=f"tcp://127.0.0.1:{ports[1]}",
            model_sub_addr=f"tcp://127.0.0.1:{ports[2]}")
        down = FakeDownstream()
        node = _make_node(tmp_cwd, up, down)
        try:
            key, _ = _wire_frames(n_deltas=0)  # ~2 KB >> 512B chunks
            assert len(key) > 512
            deadline = time.monotonic() + 10
            while not down.published and time.monotonic() < deadline:
                root.publish_model(2, key)  # re-publish beats slow-joiner
                time.sleep(0.2)
            assert down.published, "keyframe never traversed the hop"
            version, blob = down.published[0]
            assert version == 2 and blob == key  # reassembled, verbatim
        finally:
            node.close(flush_timeout_s=0)
            root.stop()

    def test_wire_base_mismatch_heals_in_one_publish(self, tmp_cwd,
                                                     fresh_registry):
        """With keyframe_interval=100, a mid-stream
        WireBaseMismatch used to black out for up to 100 publishes. The
        CMD_RESYNC path must heal it in <= 1: the diverged subscriber's
        request forces the publisher's NEXT publish to keyframe."""
        from relayrl_tpu_torch.transport.modelwire import (
            ModelWireDecoder,
            ModelWireEncoder,
            WireBaseMismatch,
        )
        from relayrl_tpu_torch.transport.zmq_backend import (
            ZmqAgentTransport,
            ZmqServerTransport,
        )

        ports = [free_port() for _ in range(3)]
        enc = ModelWireEncoder(keyframe_interval=100, small_model_bytes=0)
        root = ZmqServerTransport(
            agent_listener_addr=f"tcp://127.0.0.1:{ports[0]}",
            trajectory_addr=f"tcp://127.0.0.1:{ports[1]}",
            model_pub_addr=f"tcp://127.0.0.1:{ports[2]}")
        root.get_model = lambda: (0, b"HS")
        # the publisher-side hook (held version is a relay concern)
        root.on_resync = lambda held=-1: enc.force_keyframe()
        root.start()

        dec = ModelWireDecoder()
        versions: list[int] = []
        mismatches: list[int] = []
        sub = ZmqAgentTransport(
            agent_listener_addr=f"tcp://127.0.0.1:{ports[0]}",
            trajectory_addr=f"tcp://127.0.0.1:{ports[1]}",
            model_sub_addr=f"tcp://127.0.0.1:{ports[2]}")

        def on_model(version, blob):
            try:
                got = dec.decode(blob)
            except WireBaseMismatch as e:
                mismatches.append(version)
                sub.request_resync(e.held)
                return
            if got is not None:
                versions.append(got[0])

        sub.on_model = on_model
        sub.start_model_listener()
        try:
            rng = np.random.default_rng(1)
            params = {"w": rng.standard_normal((64, 8)).astype(np.float32)}
            arch = {"kind": "t"}

            def publish(version):
                nonlocal params
                params = {"w": params["w"] + np.float32(1e-3)}
                frame, info = enc.encode(version, arch, params)
                root.publish_model(version, frame)
                return info["kind"]

            # keyframe 1 must land (slow-joiner): re-publish until seen
            frame, _ = enc.encode(1, arch, params)
            deadline = time.monotonic() + 10
            while not versions and time.monotonic() < deadline:
                root.publish_model(1, frame)
                time.sleep(0.2)
            assert versions and versions[-1] == 1
            assert publish(2) == "delta"
            _wait_for(lambda: versions and versions[-1] == 2)
            # a delta the subscriber NEVER sees: encoder advances, the
            # wire doesn't — the next delivered delta's base mismatches
            params = {"w": params["w"] + np.float32(1e-3)}
            enc.encode(3, arch, params)
            assert publish(4) == "delta"
            _wait_for(lambda: mismatches)
            # the resync request must reach the ROUTER before the next
            # publish decides its kind
            _wait_for(lambda: enc._force_key)
            assert publish(5) == "keyframe"   # healed in ONE publish
            _wait_for(lambda: versions and versions[-1] == 5)
            assert dec.version == 5
        finally:
            sub.close()
            root.stop()

    def test_zmq_subscriber_gauge_counts_streams(self, tmp_cwd,
                                                 fresh_registry):
        """relayrl_transport_subscribers is the live
        stream count on the PUB plane — the signal that verifies a relay
        tree (root gauge == relay count, not actor count)."""
        import zmq

        from relayrl_tpu_torch.transport.zmq_backend import ZmqServerTransport

        ports = [free_port() for _ in range(3)]
        root = ZmqServerTransport(
            agent_listener_addr=f"tcp://127.0.0.1:{ports[0]}",
            trajectory_addr=f"tcp://127.0.0.1:{ports[1]}",
            model_pub_addr=f"tcp://127.0.0.1:{ports[2]}")
        root.start()
        ctx = zmq.Context.instance()
        subs = []
        try:
            def gauge():
                snap = fresh_registry.snapshot()
                for m in snap["metrics"]:
                    if (m["name"] == "relayrl_transport_subscribers"
                            and m["labels"].get("backend") == "zmq"):
                        return m["value"]
                return None

            for _ in range(2):
                s = ctx.socket(zmq.SUB)
                s.connect(f"tcp://127.0.0.1:{ports[2]}")
                s.setsockopt(zmq.SUBSCRIBE, b"")
                subs.append(s)
            _wait_for(lambda: gauge() == 2)
            subs.pop().close(linger=0)
            _wait_for(lambda: gauge() == 1)
        finally:
            for s in subs:
                s.close(linger=0)
            root.stop()


def _wait_for(pred, timeout_s: float = 10.0, interval_s: float = 0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(interval_s)
    raise AssertionError(f"condition never held: {pred}")


class TestServerResyncPath:
    def test_resync_request_rate_limited_and_coalesced(self, tmp_cwd,
                                                       fresh_registry):
        from relayrl_tpu_torch.runtime.server import TrainingServer

        addrs = {
            "agent_listener_addr": f"tcp://127.0.0.1:{free_port()}",
            "trajectory_addr": f"tcp://127.0.0.1:{free_port()}",
            "model_pub_addr": f"tcp://127.0.0.1:{free_port()}",
        }
        server = TrainingServer(
            "REINFORCE", obs_dim=3, act_dim=2, env_dir=str(tmp_cwd),
            hyperparams={"traj_per_epoch": 100, "hidden_sizes": [8, 8]},
            device="cpu", **addrs)
        try:
            assert server._wire_encoder is not None
            server._on_resync_request()
            server._on_resync_request()  # inside the window: coalesced
            assert server._wire_encoder._force_key is True
            assert server._m_resync_requests.total() == 2
            assert server._m_resync_granted.total() == 1
        finally:
            server.disable_server()


# ---------------------------------------------------------------------------
# relay-SIGKILL chaos drills (subprocess relay, live transports)
# ---------------------------------------------------------------------------

def _spawn_relay(workdir: str, cfg: dict, tag: str) -> tuple:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO_ROOT
    ready = os.path.join(workdir, f"{tag}_ready")
    stop = os.path.join(workdir, "relay_stop")
    result = os.path.join(workdir, f"{tag}_result.json")
    proc = subprocess.Popen(
        [sys.executable, "-m", "relayrl_tpu_torch.relay",
         "--json", json.dumps(cfg),
         "--ready-file", ready, "--stop-file", stop,
         "--result-path", result],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    deadline = time.monotonic() + 60
    while not os.path.exists(ready) and time.monotonic() < deadline:
        if proc.poll() is not None:
            out, _ = proc.communicate()
            raise AssertionError(
                f"relay died at bring-up (rc={proc.returncode}):"
                f"\n{out[-3000:]}")
        time.sleep(0.05)
    assert os.path.exists(ready), "relay never became ready"
    return proc, stop, result


def _drive_episodes(agent, rng, n: int, obs_dim: int, steps: int = 3):
    for _ in range(n):
        for _ in range(steps):
            agent.request_for_action(
                rng.standard_normal(obs_dim).astype(np.float32))
        agent.flag_last_action(1.0, terminated=True)


def _relay_sigkill_drill(transport: str, tmp_path, tmp_cwd):
    """SIGKILL a mid-tree relay during a live run; replacement binds the
    same fan-out addresses + spool dir. Asserts zero loss / zero
    double-train per lane and that actors resync models through the
    replacement's cache."""
    from relayrl_tpu_torch.runtime.agent import Agent
    from relayrl_tpu_torch.runtime.server import TrainingServer

    workdir = str(tmp_path)
    obs_dim = 4
    if transport == "zmq":
        root_addrs = {
            "agent_listener_addr": f"tcp://127.0.0.1:{free_port()}",
            "trajectory_addr": f"tcp://127.0.0.1:{free_port()}",
            "model_pub_addr": f"tcp://127.0.0.1:{free_port()}",
        }
        upstream = {
            "agent_listener_addr": root_addrs["agent_listener_addr"],
            "trajectory_addr": root_addrs["trajectory_addr"],
            "model_sub_addr": root_addrs["model_pub_addr"],
            "probe": False,
        }
        down_port = free_port(), free_port(), free_port()
        downstream = {
            "agent_listener_addr": f"tcp://127.0.0.1:{down_port[0]}",
            "trajectory_addr": f"tcp://127.0.0.1:{down_port[1]}",
            "model_pub_addr": f"tcp://127.0.0.1:{down_port[2]}",
        }
        agent_addrs = {
            "agent_listener_addr": downstream["agent_listener_addr"],
            "trajectory_addr": downstream["trajectory_addr"],
            "model_sub_addr": downstream["model_pub_addr"],
        }
    else:  # grpc
        root_port = free_port()
        root_addrs = {"bind_addr": f"127.0.0.1:{root_port}",
                      "native_grpc": False}
        upstream = {"server_addr": f"127.0.0.1:{root_port}",
                    "probe": False}
        relay_port = free_port()
        downstream = {"bind_addr": f"127.0.0.1:{relay_port}"}
        agent_addrs = {"server_addr": f"127.0.0.1:{relay_port}"}

    server = TrainingServer(
        "REINFORCE", obs_dim=obs_dim, act_dim=2, env_dir=workdir,
        hyperparams={"traj_per_epoch": 4, "hidden_sizes": [16, 16]},
        server_type=transport, device="cpu", **root_addrs)
    relay_cfg = {
        "name": "drill", "upstream_type": transport, "upstream": upstream,
        "downstream_type": transport if transport == "grpc" else "zmq",
        "downstream": downstream,
        "spool_dir": os.path.join(workdir, "relay_spool"),
        "batch_max": 4, "batch_linger_ms": 5.0,
    }
    proc, stop_file, _res = _spawn_relay(workdir, relay_cfg, "primary")
    agents = []
    try:
        agents = [
            Agent(server_type=transport, handshake_timeout_s=60,
                  seed=k, probe=False,
                  model_path=os.path.join(workdir, f"m{k}.rlx"),
                  identity=f"drill-{k}", device="cpu", **agent_addrs)
            for k in range(2)
        ]
        rngs = [np.random.default_rng(k) for k in range(2)]
        for agent, rng in zip(agents, rngs):
            _drive_episodes(agent, rng, 8, obs_dim)
        version_at_kill = max(a.model_version for a in agents)

        proc.kill()  # the mid-tree SIGKILL
        proc.wait(timeout=30)
        for agent, rng in zip(agents, rngs):  # sends spool/queue locally
            _drive_episodes(agent, rng, 8, obs_dim)

        proc2, stop_file, result_path = _spawn_relay(
            workdir, relay_cfg, "replacement")
        for agent, rng in zip(agents, rngs):
            _drive_episodes(agent, rng, 8, obs_dim)

        # models must advance BEHIND the relay after the failover (the
        # replacement's cache + fresh subscription serve the subtree).
        # Keep the learner PUBLISHING while waiting: if every queued
        # trajectory trained before the replacement's subscription
        # joined, there is no further publish to observe until new
        # data arrives — exactly how a live fleet behaves.
        deadline = time.monotonic() + 90
        while (min(a.model_version for a in agents) <= version_at_kill
               and time.monotonic() < deadline):
            for agent, rng in zip(agents, rngs):
                _drive_episodes(agent, rng, 1, obs_dim)
            time.sleep(0.2)
        assert min(a.model_version for a in agents) > version_at_kill

        # at-least-once convergence: one FULL replay pass per agent
        for agent in agents:
            assert agent.spool.flush(deadline_s=60), "spool never flushed"
        # zmq PUSH is fire-and-forget: give the pipe a beat
        time.sleep(1.0)

        # tree down LAST (flushes the relay spool upstream), then
        # reconcile: every seq accepted exactly once, per lane
        with open(stop_file, "w") as f:
            f.write("stop")
        out2, _ = proc2.communicate(timeout=60)
        server.drain(timeout=60)
        sent = {}
        for agent in agents:
            sent.update(agent.spool.sent_counts())
        # 24 scripted episodes + however many the publish-wait drove
        assert sent and all(n >= 24 for n in sent.values()), sent
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            rows = server.ingest_accounting()["agents"]
            if all(ident in rows and rows[ident]["max_seq"] == n
                   and rows[ident]["contiguous"]
                   for ident, n in sent.items()):
                break
            time.sleep(0.5)
            server.drain(timeout=15)
        acct = server.ingest_accounting()
        for ident, n in sent.items():
            row = acct["agents"].get(ident)
            assert row == {"max_seq": n, "accepted": n,
                           "contiguous": True}, (ident, row, out2[-2000:])
        # zero double-train: unique episodes trained exactly once
        assert server.stats["trajectories"] == sum(sent.values())
        # the replacement actually restored + served the subtree
        repl = json.load(open(result_path))
        assert repl["stats"]["trajectory_frames_forwarded"] > 0
    finally:
        for agent in agents:
            agent.disable_agent()
        for p in (proc,):
            if p.poll() is None:
                p.kill()
        server.disable_server()


def test_relay_sigkill_drill_zmq(tmp_path, tmp_cwd, fresh_registry):
    _relay_sigkill_drill("zmq", tmp_path, tmp_cwd)


def test_port_relay_forwards_jax_frames_byte_equal(tmp_cwd, fresh_registry):
    """JAX TrainingServer -> port RelayNode (zmq up, zmq down) -> port
    Agent: every model blob the agent receives is one the JAX server
    published, byte for byte, and the agent installs the JAX params."""
    import jax

    from relayrl_tpu.runtime.server import TrainingServer as JaxServer
    from relayrl_tpu_torch.relay import RelayNode
    from relayrl_tpu_torch.runtime.agent import Agent
    from relayrl_tpu_torch.weights import params_to_jax, tree_digest

    config_path = os.path.join(str(tmp_cwd), "relay_config.json")
    with open(config_path, "w") as f:
        json.dump({"guardrails": {"enabled": False},
                   "transport": {"small_model_bytes": 0,
                                 "keyframe_interval": 3}}, f)
    ports = [free_port() for _ in range(6)]
    server = JaxServer(
        "REINFORCE", obs_dim=4, act_dim=2, env_dir=str(tmp_cwd),
        config_path=config_path,
        hyperparams={"traj_per_epoch": 2, "hidden_sizes": [16, 16],
                     "train_vf_iters": 3, "with_vf_baseline": True,
                     "bucket_lengths": [16], "seed_salt": 0},
        agent_listener_addr=f"tcp://127.0.0.1:{ports[0]}",
        trajectory_addr=f"tcp://127.0.0.1:{ports[1]}",
        model_pub_addr=f"tcp://127.0.0.1:{ports[2]}")
    published = {}
    publish = server.transport.publish_model

    def spy(version, blob, *a, **k):
        published.setdefault(int(version), []).append(bytes(blob))
        return publish(version, blob, *a, **k)

    server.transport.publish_model = spy
    relay = RelayNode(
        config_path=config_path, name="interop", upstream_type="zmq",
        upstream={"agent_listener_addr": f"tcp://127.0.0.1:{ports[0]}",
                  "trajectory_addr": f"tcp://127.0.0.1:{ports[1]}",
                  "model_sub_addr": f"tcp://127.0.0.1:{ports[2]}",
                  "probe": False},
        downstream_type="zmq",
        downstream={"agent_listener_addr": f"tcp://127.0.0.1:{ports[3]}",
                    "trajectory_addr": f"tcp://127.0.0.1:{ports[4]}",
                    "model_pub_addr": f"tcp://127.0.0.1:{ports[5]}"},
        batch_max=4, batch_linger_ms=5.0)
    agent = None
    try:
        agent = Agent(config_path=config_path, seed=0, probe=False,
                      device="cpu",
                      agent_listener_addr=f"tcp://127.0.0.1:{ports[3]}",
                      trajectory_addr=f"tcp://127.0.0.1:{ports[4]}",
                      model_sub_addr=f"tcp://127.0.0.1:{ports[5]}")
        received = []
        deliver = agent.transport.on_model

        def tap(version, blob):
            received.append((int(version), bytes(blob)))
            deliver(version, blob)

        agent.transport.on_model = tap
        rng = np.random.default_rng(0)
        for target in range(1, 4):
            _drive_episodes(agent, rng, 2, 4, steps=5)
            _wait_for(lambda t=target: agent.model_version == t, 60)
        assert received
        for version, blob in received:
            assert blob in published[version], version
        server.drain(timeout=30)
        assert tree_digest(params_to_jax(agent.actor.params)) == \
            tree_digest(jax.device_get(server.algorithm.state.params))
        acct = server.ingest_accounting()["agents"]
        for ident, n in agent.spool.sent_counts().items():
            assert acct[ident] == {"max_seq": n, "accepted": n,
                                   "contiguous": True}
    finally:
        if agent is not None:
            agent.disable_agent()
        relay.close(flush_timeout_s=5)
        server.disable_server()


@pytest.mark.parametrize("telemetry", [{"trace_sample_rate": 0.5},
                                       {"fleet_interval_s": 1.0}])
def test_refuses_tracing_and_fleet(tmp_cwd, telemetry):
    """The relay once refused these keys; it now takes each one and acts
    on it: with tracing a sampled trajectory's forward records the relay
    hop under its trace id and leaves the wire id verbatim; with the
    fleet plane a subtree snapshot frame never enters the forward path
    and the flush sends one merged frame upstream."""
    from relayrl_tpu_torch.relay import RelayNode
    from relayrl_tpu_torch.telemetry import aggregate as ag
    from relayrl_tpu_torch.telemetry import trace as trace_mod

    from relayrl_tpu_torch import telemetry as tel

    tel.reset_for_tests()  # the config below must be the first one seen
    FakeUpstream, FakeDownstream = _make_fakes()
    path = os.path.join(str(tmp_cwd), "telemetry.json")
    with open(path, "w") as f:
        json.dump({"telemetry": {"enabled": True, "port": None,
                                 **telemetry}}, f)
    up = FakeUpstream()
    node = RelayNode(config_path=path, name="relay-t", batch_max=1,
                     spool_entries=0, upstream_transport=up,
                     downstream_transport=FakeDownstream())
    try:
        if "trace_sample_rate" in telemetry:
            ctx = trace_mod.TrajCtx("ab-1", 5, 2)
            wire_id = trace_mod.tag_agent_trace("w1", ctx.encode()) + "#s1"
            node._on_subtree_trajectory(wire_id, b"payload")
            assert up.sent == [(wire_id, b"payload")]
            spans = trace_mod.snapshot_spans()
            assert [(s["kind"], s["trace"], s["hop"], s["relay"])
                    for s in spans] == [("traj", "ab-1", "relay", "relay-t")]
        else:
            frame = ag.encode_snapshot_frame([ag.snapshot_section(
                {"metrics": []}, "w1", "actor", 1.0, 1)])
            node._on_subtree_trajectory(ag.fleet_wire_id("w1"), frame)
            assert up.sent == []
            node._fleet_flush()
            (wid, payload), = up.sent
            assert wid == ag.fleet_wire_id("relay-t")
            assert [s["proc"] for s in ag.parse_snapshot_frame(payload)] \
                == ["w1", "relay-t"]
    finally:
        node.close()
        tel.reset_for_tests()




@pytest.mark.parametrize("fleet", [False, True])
def test_relay_drains_its_closing_fleet_frame(tmp_cwd, fleet):
    """With the fleet plane on, the relay's closing frame is its last send
    and its upstream closes with ``FLEET_DRAIN_S`` to let that frame leave
    (a zmq send only queues it); without the plane it closes at once."""
    from relayrl_tpu_torch import telemetry as tel
    from relayrl_tpu_torch.relay import RelayNode
    from relayrl_tpu_torch.telemetry import aggregate as ag

    tel.reset_for_tests()
    FakeUpstream, FakeDownstream = _make_fakes()
    path = os.path.join(str(tmp_cwd), "telemetry.json")
    with open(path, "w") as f:
        json.dump({"telemetry": {"enabled": True, "port": None,
                                 **({"fleet_interval_s": 5.0} if fleet
                                    else {})}}, f)
    up = FakeUpstream()
    try:
        node = RelayNode(config_path=path, name="relay-d", batch_max=1,
                         spool_entries=0, upstream_transport=up,
                         downstream_transport=FakeDownstream())
        node.close()
    finally:
        tel.reset_for_tests()
    if fleet:
        assert [wid for wid, _ in up.sent] == [ag.fleet_wire_id("relay-d")]
        assert up.closed_with == ag.FLEET_DRAIN_S
    else:
        assert up.sent == [] and up.closed_with == 0.0
