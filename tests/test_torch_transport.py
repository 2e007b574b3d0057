"""The port's transport plane against the JAX package's, byte for byte.

* Trajectory envelopes, sequence and trace tags, and RLD1 columnar frames
  are byte-equal, and each package parses the other's.
* Model-wire v2 frames (keyframes, deltas, chunks) from the same params
  sequence are byte-equal, in float32 and bfloat16, and each package's
  decoder rebuilds the other's frames into bit-equal params.
* The trajectory spool and the sequence ledger pass the JAX package's unit
  tests (``tests/test_recovery.py``), parametrised over both packages.
* The columnar branch of the epoch buffer pads like the JAX package's.
* The native and gRPC transports build their own backends and never fall
  back to ZMQ.
* A ZMQ agent transport's ``close(drain_s)`` delivers what was queued.

Tolerances: none — every comparison here is exact.
"""

import os
import time

import ml_dtypes
import numpy as np
import pytest

from relayrl_tpu.data.replay_buffer import EpochBuffer as JaxEpochBuffer
from relayrl_tpu.runtime import spool as jax_spool
from relayrl_tpu.transport import base as jax_base
from relayrl_tpu.transport import modelwire as jax_wire
from relayrl_tpu.transport import retry as jax_retry
from relayrl_tpu.types import columnar as jax_columnar
from relayrl_tpu_torch.data import EpochBuffer
from relayrl_tpu_torch.runtime import spool as port_spool
from relayrl_tpu_torch.transport import base as port_base
from relayrl_tpu_torch.transport import modelwire as port_wire
from relayrl_tpu_torch.transport import retry as port_retry
from relayrl_tpu_torch.types import columnar as port_columnar
from tests._util import free_port

OBS, ACT = 5, 3


# -- envelopes and tags ----------------------------------------------------

@pytest.mark.parametrize("agent_id", ["a", "AGENT_ID-1234abcd.lane3", "ü-λ"])
def test_envelopes_and_tags_byte_equal(agent_id):
    payload = bytes(range(200))
    env = port_base.pack_trajectory_envelope(agent_id, payload)
    assert env == jax_base.pack_trajectory_envelope(agent_id, payload)
    assert jax_base.unpack_trajectory_envelope(env) == (agent_id, payload)
    assert port_base.unpack_trajectory_envelope(env) == (agent_id, payload)
    tagged = port_base.tag_agent_seq(agent_id, 42)
    assert tagged == jax_base.tag_agent_seq(agent_id, 42)
    assert port_base.split_agent_seq(tagged) == (agent_id, 42)
    assert jax_base.split_agent_seq(tagged) == (agent_id, 42)
    ctx = "0123abcd.ff.7"
    traced = port_base.tag_agent_trace(tagged, ctx)
    assert traced == jax_base.tag_agent_trace(tagged, ctx)
    assert port_base.split_agent_trace(traced) == (tagged, ctx)
    frame = port_base.pack_model_frame(7, b"model", pub_ns=123)
    assert frame == jax_base.pack_model_frame(7, b"model", pub_ns=123)
    assert port_base.unpack_model_frame_ex(frame) == (7, b"model", 123)


def _decoded(mod, n: int, obs_dtype=np.float32, final: bool = True):
    return mod.DecodedTrajectory(
        agent_id="lane0", n_steps=n, n_records=n + 1,
        marker_truncated=not final,
        columns={"o": np.arange(n * OBS, dtype=obs_dtype).reshape(n, OBS),
                 "a": (np.arange(n) % ACT).astype(np.int32),
                 "r": np.linspace(-1, 1, n).astype(np.float32),
                 "t": np.eye(1, n, n - 1, dtype=np.uint8)[0],
                 "u": np.ones(n, np.uint8),
                 "x": np.zeros(n, np.uint8)},
        aux={"v": np.linspace(0, 1, n).astype(np.float32),
             "logp_a": np.linspace(-1, 0, n).astype(np.float32)},
        final_obs=(np.arange(OBS, dtype=np.float32) if final else None))


@pytest.mark.parametrize("n,final", [(1, True), (7, False), (33, True)])
def test_columnar_frames_byte_equal_and_cross_parse(n, final):
    ours = port_columnar.encode_columnar_frame(_decoded(port_columnar, n,
                                                        final=final))
    theirs = jax_columnar.encode_columnar_frame(_decoded(jax_columnar, n,
                                                         final=final))
    assert ours == theirs
    assert port_columnar.is_columnar_frame(ours)
    for parse, frame in ((port_columnar.parse_frame, theirs),
                         (jax_columnar.parse_frame, ours)):
        got = parse(frame, agent_id="x")
        want = _decoded(port_columnar, n, final=final)
        assert (got.agent_id, got.n_steps, got.n_records,
                got.marker_truncated) == ("x", n, n + 1, not final)
        for key, col in want.columns.items():
            assert np.array_equal(got.columns[key], col), key
        for key, col in want.aux.items():
            assert np.array_equal(got.aux[key], col), key
    corrupt = bytearray(ours)
    corrupt[len(corrupt) // 2] ^= 0xFF
    with pytest.raises(ValueError):
        port_columnar.parse_frame(bytes(corrupt))


def test_columnar_episodes_pad_like_the_jax_buffer():
    """The epoch buffer's columnar branch: the same frames, parsed by each
    package, drain into byte-equal batches."""
    ours = EpochBuffer(OBS, ACT, traj_per_epoch=3, buckets=(16, 64))
    theirs = JaxEpochBuffer(OBS, ACT, traj_per_epoch=3, buckets=(16, 64))
    for n, final in ((5, True), (20, False), (9, True)):
        frame = jax_columnar.encode_columnar_frame(
            _decoded(jax_columnar, n, final=final))
        ready = ours.add_episode(port_columnar.parse_frame(frame))
        assert ready == theirs.add_episode(jax_columnar.parse_frame(frame))
    got, want = ours.drain().as_dict(), theirs.drain().as_dict()
    assert got.keys() == want.keys()
    for key in got:
        assert got[key].dtype == want[key].dtype
        assert np.array_equal(got[key], want[key]), key
    assert port_columnar.trajectory_is_finite(
        port_columnar.parse_frame(frame))


# -- model wire v2 -----------------------------------------------------------

def _params_sequence(dtype, steps: int = 6, seed: int = 0):
    """A params tree moving by small updates, with a frozen leaf (skipped
    by deltas) and an int leaf."""
    rng = np.random.default_rng(seed)
    tree = {"params": {
        "dense_0": {"kernel": rng.standard_normal((48, 64)).astype(dtype),
                    "bias": np.zeros(64, dtype)},
        "frozen": {"embed": rng.standard_normal((32, 16)).astype(dtype)},
        "count": np.arange(10, dtype=np.int32)}}
    out = []
    for step in range(steps):
        step_tree = {"params": {
            "dense_0": {k: (v + (1e-3 * step * rng.standard_normal(v.shape))
                            .astype(np.float32)).astype(dtype)
                        for k, v in tree["params"]["dense_0"].items()},
            "frozen": tree["params"]["frozen"],
            "count": tree["params"]["count"] + step}}
        out.append(step_tree)
    return out


def _leaves(tree):
    from relayrl_tpu_torch.types.model_bundle import leaf_manifest

    return leaf_manifest(tree)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("compress", ["zlib", False])
def test_model_frames_byte_equal_and_cross_decode(dtype, compress):
    arch = {"kind": "mlp_discrete", "obs_dim": 48, "act_dim": 2}
    kw = dict(keyframe_interval=3, compress=compress, small_model_bytes=0)
    ours, theirs = port_wire.ModelWireEncoder(**kw), jax_wire.ModelWireEncoder(**kw)
    port_dec, jax_dec = port_wire.ModelWireDecoder(), jax_wire.ModelWireDecoder()
    kinds = []
    for version, params in enumerate(_params_sequence(dtype), start=1):
        frame, info = ours.encode(version, arch, params)
        jax_frame, jax_info = theirs.encode(version, arch, params)
        assert frame == jax_frame, (version, info["kind"])
        assert info["kind"] == jax_info["kind"]
        kinds.append(info["kind"])
        # Chunked: split and reassembled identically by both packages.
        chunks = port_wire.split_frame(frame, 1000, version)
        assert chunks == jax_wire.split_frame(frame, 1000, version)
        assert len(chunks) > 1
        reasm = port_wire.ChunkReassembler()
        got = [reasm.feed(c) for c in chunks]
        assert got[:-1] == [None] * (len(chunks) - 1) and got[-1] == frame
        # Each package decodes the other's frame to bit-equal params.
        for dec, blob in ((port_dec, jax_frame), (jax_dec, frame)):
            ver, got_arch, tree = dec.decode(blob)
            assert (ver, got_arch) == (version, arch)
            manifest, leaves = _leaves(tree)
            want_manifest, want_leaves = _leaves(params)
            assert manifest == want_manifest
            for a, b in zip(leaves, want_leaves):
                assert a.dtype == b.dtype
                assert a.view(np.uint8).tobytes() == b.view(np.uint8).tobytes()
    assert kinds == ["keyframe", "delta", "delta", "keyframe", "delta", "delta"]


def test_small_models_pass_through_as_v1_bundles():
    from relayrl_tpu.types.model_bundle import ModelBundle as JaxModelBundle

    params = _params_sequence(np.float32, steps=1)[0]
    frame, info = port_wire.ModelWireEncoder().encode(3, {"kind": "x"}, params)
    assert info["kind"] == "v1_passthrough"
    assert not port_wire.is_wire_frame(frame)
    assert frame == jax_wire.ModelWireEncoder().encode(3, {"kind": "x"},
                                                       params)[0]
    back = JaxModelBundle.from_bytes(frame,
                                     params_template=JaxModelBundle.RAW_TREE)
    assert back.version == 3


def test_delta_base_mismatch_requests_resync():
    arch = {"kind": "x"}
    seq = _params_sequence(np.float32, steps=3)
    enc = jax_wire.ModelWireEncoder(keyframe_interval=10, small_model_bytes=0)
    frames = [enc.encode(v, arch, p)[0] for v, p in enumerate(seq, start=1)]
    dec = port_wire.ModelWireDecoder()
    assert dec.decode(frames[0])[0] == 1
    with pytest.raises(port_wire.WireBaseMismatch) as err:
        dec.decode(frames[2])  # skipped version 2
    assert (err.value.base, err.value.held) == (2, 1)
    assert dec.decode(frames[2]) is None  # waits for a keyframe
    enc.force_keyframe()
    key = enc.encode(4, arch, seq[-1])[0]
    assert dec.decode(key)[0] == 4


# -- spool and ledger: tests/test_recovery.py's units over both packages ----

SPOOLS = pytest.mark.parametrize(
    "mods", [(port_spool, port_retry), (jax_spool, jax_retry)],
    ids=["port", "jax"])


@SPOOLS
def test_spool_bounded_eviction_keeps_newest(mods):
    spool = mods[0].TrajectorySpool(send_fn=None, max_entries=3)
    for i in range(6):
        spool.send(b"p%d" % i, "a")
    assert spool.depth == 3
    assert [seq for _, seq, _ in spool._entries] == [4, 5, 6]
    assert spool.sent_counts() == {"a": 6}


@SPOOLS
def test_spool_byte_bound_evicts(mods):
    spool = mods[0].TrajectorySpool(send_fn=None, max_entries=100,
                                    max_bytes=1 << 16)
    big = b"x" * 30_000
    for _ in range(5):
        spool.send(big, "a")
    assert spool.depth <= 2


@SPOOLS
def test_disk_spool_survives_process_death(mods, tmp_path):
    d = str(tmp_path)
    spool = mods[0].TrajectorySpool(send_fn=None, max_entries=10,
                                    directory=d, name="worker0")
    for i in range(4):
        spool.send(b"payload-%d" % i, "lane0")
    spool.send(b"other", "lane1")
    spool.close()
    reborn = mods[0].TrajectorySpool(send_fn=None, max_entries=10,
                                     directory=d, name="worker0")
    assert reborn.depth == 5
    assert reborn.sent_counts() == {"lane0": 4, "lane1": 1}
    assert reborn.send(b"new", "lane0") == 5
    sent = []
    reborn.send_fn = lambda p, tagged: sent.append((p, tagged))
    assert reborn.replay() == 6
    assert (b"payload-0", "lane0#s1") in sent


def test_disk_spool_files_interchange(tmp_path):
    """A spool file one package wrote, the other reads back whole."""
    d = str(tmp_path)
    spool = port_spool.TrajectorySpool(send_fn=None, directory=d, name="x")
    for i in range(3):
        spool.send(b"p%d" % i, "a")
    spool.close()
    other = jax_spool.TrajectorySpool(send_fn=None, directory=d, name="x")
    assert other.depth == 3 and other.sent_counts() == {"a": 3}


@SPOOLS
def test_disk_spool_tolerates_torn_tail(mods, tmp_path):
    d = str(tmp_path)
    spool = mods[0].TrajectorySpool(send_fn=None, directory=d, name="t")
    spool.send(b"whole", "a")
    spool.close()
    with open(os.path.join(d, "t.spool"), "ab") as f:
        f.write(b"\x00\x00\x00\xffTORN")
    reborn = mods[0].TrajectorySpool(send_fn=None, directory=d, name="t")
    assert reborn.depth == 1
    reborn.send(b"second-life", "a")
    reborn.close()
    third = mods[0].TrajectorySpool(send_fn=None, directory=d, name="t")
    assert third.depth == 2
    assert third.sent_counts() == {"a": 2}


@SPOOLS
def test_breaker_opens_then_heal_replays(mods):
    spool_mod, retry_mod = mods
    alive = {"up": False}
    delivered = []

    def send_fn(payload, tagged):
        if not alive["up"]:
            raise ConnectionError("server down")
        delivered.append((payload, tagged))

    spool = spool_mod.TrajectorySpool(
        send_fn=send_fn, max_entries=100,
        retry=retry_mod.RetryPolicy(base_delay_s=0.001, max_delay_s=0.002,
                                    deadline_s=0.01, max_attempts=2),
        breaker=retry_mod.CircuitBreaker("t", failure_threshold=2,
                                         reset_timeout_s=0.05))
    spool.send(b"a", "x")
    spool.send(b"b", "x")
    assert spool.breaker.state == "open"
    spool.send(b"c", "x")
    assert not delivered and spool.depth == 3
    alive["up"] = True
    time.sleep(0.06)
    spool.send(b"d", "x")
    assert spool.breaker.state == "closed"
    payloads = [p for p, _ in delivered]
    assert payloads.count(b"a") >= 1 and payloads.count(b"c") >= 1
    assert set(payloads) == {b"a", b"b", b"c", b"d"}


@SPOOLS
def test_ledger_monotonic_accept_and_dup_drop(mods):
    led = mods[0].SequenceLedger(window=64)
    assert all(led.accept("a", s) for s in (1, 2, 3))
    assert not led.accept("a", 2)
    assert led.accept("b", 1)
    assert led.total_duplicates() == 1
    assert led.counts()["a"] == {"max_seq": 3, "accepted": 3,
                                 "contiguous": True}


@SPOOLS
def test_ledger_out_of_order_within_window(mods):
    led = mods[0].SequenceLedger(window=16)
    assert led.accept("a", 5)
    assert led.accept("a", 3)
    assert not led.accept("a", 3)
    assert led.counts()["a"]["contiguous"] is False


@SPOOLS
def test_ledger_below_window_treated_as_duplicate(mods):
    led = mods[0].SequenceLedger(window=4)
    assert led.accept("a", 100)
    assert not led.accept("a", 95)
    assert led.accept("a", 97)


@pytest.mark.parametrize("writer,reader", [(port_spool, jax_spool),
                                           (jax_spool, port_spool),
                                           (port_spool, port_spool)],
                         ids=["port-to-jax", "jax-to-port", "port"])
def test_ledger_sidecar_roundtrip(writer, reader, tmp_path):
    led = writer.SequenceLedger(window=32)
    for s in (1, 2, 4):
        led.accept("a", s)
    led.accept("a", 2)
    path = str(tmp_path / "ledger.json")
    led.save(path)
    back = reader.SequenceLedger.load(path)
    assert back.window == 32
    assert back.total_duplicates() == 1
    assert not back.accept("a", 4)
    assert back.accept("a", 3)


@SPOOLS
def test_ledger_retract_reopens_seq(mods):
    led = mods[0].SequenceLedger(window=16)
    assert led.accept("a", 1)
    led.retract("a", 1)
    assert led.accept("a", 1)
    assert led.counts()["a"]["accepted"] == 1


# -- what the port refuses ----------------------------------------------------

@pytest.mark.parametrize("server_type", ["grpc", "native"])
def test_unported_transports_raise(server_type):
    """Both were refused before their ports; now each builds its own
    backend (never a fallback to ZMQ): native the C++ framed-TCP core, a
    grpc server the native C++ gRPC server when the library builds (else
    grpcio), a grpc agent grpcio."""
    from relayrl_tpu_torch.config import ConfigLoader
    from relayrl_tpu_torch.transport import (
        grpc_backend,
        make_agent_transport,
        make_server_transport,
        native_bindings,
    )
    from relayrl_tpu_torch.transport.native_backend import native_available

    config = ConfigLoader(None, None, create_if_missing=False)
    addr = f"127.0.0.1:{free_port()}"
    server = make_server_transport(server_type, config, bind_addr=addr)
    agent = make_agent_transport(server_type, config, probe=False,
                                 server_addr=addr)
    if server_type == "grpc":
        assert isinstance(server, native_bindings.NativeGrpcServerTransportImpl
                          if native_available() else
                          grpc_backend.GrpcServerTransport)
        assert isinstance(agent, grpc_backend.GrpcAgentTransport)
    else:
        assert isinstance(server, native_bindings.NativeServerTransportImpl)
        assert isinstance(agent, native_bindings.NativeAgentTransportImpl)
    agent.close()
    with pytest.raises(ValueError, match="unknown server_type"):
        make_server_transport("carrier-pigeon", config)


@pytest.mark.parametrize("server_type", ["native", "auto", "NATIVE", None,
                                         "zmq", "grpc", "carrier-pigeon"])
def test_server_type_resolves_as_reference(server_type, monkeypatch):
    """Both constructors share one check of ``server_type``; ``native`` is
    a backend of its own and a server's ``auto`` resolves to native when
    the C++ core loads, else zmq, in both packages (the library's presence
    pinned either way); an unknown name is refused with the reference's
    message."""
    import relayrl_tpu.transport as jax_transport
    import relayrl_tpu.transport.native_backend as jax_native
    import relayrl_tpu_torch.transport as transport
    import relayrl_tpu_torch.transport.native_backend as native

    if server_type == "carrier-pigeon":
        with pytest.raises(ValueError, match="unknown server_type") as err:
            transport._check_type(server_type)
        with pytest.raises(ValueError) as jax_err:
            jax_transport.make_agent_transport(server_type, None)
        assert str(err.value) == str(jax_err.value)
        return
    assert transport._check_type(server_type) == (server_type or "zmq").lower()
    for loads in (True, False):
        monkeypatch.setattr(native, "native_available", lambda: loads)
        monkeypatch.setattr(jax_native, "native_available", lambda: loads)
        assert transport._resolve_auto() == jax_transport._resolve_auto() == (
            "native" if loads else "zmq")


# -- closing without losing the last frames ------------------------------------

def test_zmq_close_drains_queued_frames():
    """Frames handed to ``send_trajectory`` just before ``close(drain_s)``
    all reach the peer: the close waits for the PUSH pipe to empty (the
    closing fleet frame that carries a relay's last replays rides it)."""
    import zmq

    from relayrl_tpu_torch.transport.zmq_backend import ZmqAgentTransport

    ctx = zmq.Context()
    pull = ctx.socket(zmq.PULL)
    port = pull.bind_to_random_port("tcp://127.0.0.1")
    n, payload = 64, bytes(range(256)) * 256
    try:
        agent = ZmqAgentTransport(f"tcp://127.0.0.1:{free_port()}",
                                  f"tcp://127.0.0.1:{port}",
                                  f"tcp://127.0.0.1:{free_port()}")
        for i in range(n):
            agent.send_trajectory(payload, agent_id=f"a{i}")
        agent.close(drain_s=10.0)
        got = []
        while pull.poll(2000):
            got.append(port_base.unpack_trajectory_envelope(pull.recv()))
        assert [a for a, _ in got] == [f"a{i}" for i in range(n)]
        assert all(p == payload for _, p in got)
    finally:
        pull.close(linger=0)
        ctx.term()


@pytest.mark.parametrize("drain_s", [0.0, 0.5])
def test_zmq_close_with_no_peer_is_bounded(drain_s):
    """With nobody listening the queued frame cannot leave: the close
    returns after at most ``drain_s`` (at 0 at once, as before)."""
    from relayrl_tpu_torch.transport.zmq_backend import ZmqAgentTransport

    agent = ZmqAgentTransport(*(f"tcp://127.0.0.1:{free_port()}"
                                for _ in range(3)))
    agent.send_trajectory(b"lost", agent_id="a")
    t0 = time.monotonic()
    agent.close(drain_s=drain_s)
    elapsed = time.monotonic() - t0
    assert elapsed < drain_s + 1.0, elapsed
    if drain_s:
        assert elapsed >= drain_s * 0.8, elapsed

