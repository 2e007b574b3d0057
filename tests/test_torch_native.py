"""The port's native plane: its build of ``native/``, the codec, the
transports and the server's decoded drain, against the JAX package.

* The port compiles ``native/*.cc`` into ``build/relayrl_tpu_torch/``
  under a name that hashes the sources and flags, and leaves ``native/``
  as it was.
* ``NativeDecoder`` on the payloads of ``tests/test_native_codec.py``'s
  ``TestColumnarParity`` and ``TestFallbacks``: the port's decode equals
  the JAX package's, and its padded batch equals the port's Python decode.
* A native round trip: a port ``TrainingServer`` over ``native`` trains
  from a port ``VectorAgent`` that negotiates ``auto``, every trajectory
  decoded by the C++ codec, every publish installed bit for bit.
* Interop both ways, every model blob byte-equal to a published one: a
  port native agent feeds a JAX native server, and a JAX native agent a
  port native server.
* ``auto``, ``grpc`` and ``grpc`` with ``native_grpc=False`` resolve as
  the JAX package's do, with and without the library.
* ``_on_trajectory_decoded`` gives the JAX server's guardrail verdicts on
  one stream.
"""

import hashlib
import json
import os
import time

import jax
import numpy as np
import pytest

from relayrl_tpu import faults as jax_faults
from relayrl_tpu import telemetry as jax_telemetry
from relayrl_tpu.transport.native_backend import native_available as jax_native_available
from relayrl_tpu.types import columnar as jax_columnar
from relayrl_tpu_torch import _native, faults, telemetry
from relayrl_tpu_torch.data.batching import (
    fold_trailing_markers,
    pad_decoded,
    pad_trajectory,
    pick_bucket,
)
from relayrl_tpu_torch.transport.base import (
    pack_trajectory_envelope,
    unpack_trajectory_envelope,
)
from relayrl_tpu_torch.types import columnar
from relayrl_tpu_torch.types.action import ActionRecord
from relayrl_tpu_torch.types.trajectory import deserialize_actions, serialize_actions
from relayrl_tpu_torch.weights import params_to_jax, tree_digest
from tests._util import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "native")
HP = {"traj_per_epoch": 2, "hidden_sizes": [16, 16], "train_vf_iters": 3,
      "with_vf_baseline": True, "bucket_lengths": [16], "seed_salt": 0}
CONFIG = {"guardrails": {"enabled": False},
          "transport": {"small_model_bytes": 0, "keyframe_interval": 3}}


@pytest.fixture(autouse=True)
def _clean_planes():
    for mod in (faults, telemetry, jax_faults, jax_telemetry):
        mod.reset_for_tests()
    yield
    for mod in (faults, telemetry, jax_faults, jax_telemetry):
        mod.reset_for_tests()


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's library, through its own ``native_available``.

    The JAX package's codec caches its first look for the library, and a
    test module imported before the build (a module-level skip condition
    under xdist's collection) may have cached "absent": clear that answer
    so the codec looks again, now that the library is there."""
    if not jax_native_available():
        pytest.fail("the JAX package's native library did not build")
    with jax_columnar._codec_lock:
        jax_columnar._codec_checked = False
        jax_columnar._codec_lib = None
    assert jax_columnar.native_codec_available()


def _native_snapshot() -> dict:
    out = {}
    for name in sorted(os.listdir(NATIVE)):
        path = os.path.join(NATIVE, name)
        with open(path, "rb") as f:
            out[name] = (os.stat(path).st_mtime_ns,
                         hashlib.sha256(f.read()).hexdigest())
    return out


def test_build_goes_to_build_dir_and_leaves_native_alone(tmp_path, monkeypatch):
    ours = {name for name in os.listdir(NATIVE)}
    before = _native_snapshot()
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_native, "_built", {})
    path = _native.build()
    assert path.parent == tmp_path / "build"
    assert path.name.startswith("librelayrl_native-") and path.suffix == ".so"
    assert path.exists() and path == _native.library_path()
    assert path.with_suffix(".log").exists()
    assert not list(path.parent.glob("*.tmp"))
    assert _native_snapshot() == before
    assert set(os.listdir(NATIVE)) == ours
    monkeypatch.setattr(_native, "CXX_FLAGS", _native.CXX_FLAGS + ("-g",))
    assert _native.library_path() != path  # the flags are in the name


# ---------------------------------------------------------------------------
# the codec against the JAX package's and the Python decode
# ---------------------------------------------------------------------------
def _mk_steps(n, obs_dim=4, act_dim=2, discrete=True, with_mask=False,
              with_aux=True, seed=0):
    """``tests/test_native_codec.py::_mk_steps`` with the port's records."""
    rng = np.random.default_rng(seed)
    steps = []
    for i in range(n):
        act = (np.int64(rng.integers(act_dim)) if discrete
               else rng.standard_normal(act_dim).astype(np.float32))
        data = None
        if with_aux:
            data = {"logp_a": np.float32(rng.standard_normal()),
                    "v": np.float32(rng.standard_normal())}
        steps.append(ActionRecord(
            obs=rng.standard_normal(obs_dim).astype(np.float32), act=act,
            mask=(np.ones(act_dim, np.float32) if with_mask else None),
            rew=float(rng.standard_normal()), data=data, done=(i == n - 1)))
    return steps


def _unmark_last(steps):
    last = steps[-1]
    steps[-1] = ActionRecord(obs=last.obs, act=last.act, rew=last.rew,
                             data=last.data, mask=last.mask, done=False)
    return steps


def _pixels(seed=7):
    rng = np.random.default_rng(seed)
    return [ActionRecord(obs=rng.integers(0, 256, 288, dtype=np.uint8),
                         act=np.int64(rng.integers(3)), rew=float(rng.random()),
                         data={"logp_a": np.float32(-0.3), "v": np.float32(0.1)},
                         done=(i == 7)) for i in range(8)]


def _images():
    rng = np.random.default_rng(3)
    return [ActionRecord(obs=rng.integers(0, 255, (8, 8, 3)).astype(np.uint8),
                         act=np.int64(1), rew=1.0, done=(i == 2))
            for i in range(3)]


def _mixed_obs():
    steps = _mk_steps(4)
    steps[2] = ActionRecord(obs=np.zeros(7, np.float32), act=np.int64(0),
                            rew=0.0, done=False)
    return steps


def _aux_variant(data):
    steps = _mk_steps(3)
    steps[1] = ActionRecord(obs=steps[1].obs, act=steps[1].act, rew=0.0,
                            data=data, done=False)
    return steps


# case -> (steps or raw payload, obs_dim, act_dim, discrete, horizon);
# obs_dim None: no padded comparison.
PAYLOADS = {
    "plain": (lambda: _mk_steps(17), 4, 2, True, None),
    "continuous": (lambda: _mk_steps(9, act_dim=3, discrete=False), 4, 3,
                   False, None),
    "masks": (lambda: _mk_steps(12, with_mask=True), 4, 2, True, None),
    "no_aux": (lambda: _mk_steps(5, with_aux=False), 4, 2, True, None),
    "uint8_pixels": (_pixels, 288, 3, True, None),
    "terminal_marker": (lambda: _unmark_last(_mk_steps(10))
                        + [ActionRecord(rew=2.5, done=True)], 4, 2, True, None),
    "truncation_marker": (lambda: _unmark_last(_mk_steps(8)) + [ActionRecord(
        obs=np.arange(4, dtype=np.float32), rew=0.5, done=True,
        truncated=True, mask=np.ones(2, np.float32))], 4, 2, True, None),
    "trailing_markers": (lambda: _mk_steps(6) + [
        ActionRecord(rew=1.0, done=False),
        ActionRecord(obs=np.full(4, 7, np.float32), rew=2.0, done=True,
                     truncated=True)], 4, 2, True, None),
    "marker_only": (lambda: [ActionRecord(rew=1.0, done=True)], 4, 2, True,
                    None),
    "long_episode": (lambda: _mk_steps(40), 4, 2, True, 16),
    "image_obs": (_images, None, 2, True, None),
    # TestFallbacks: the C++ codec hands these back raw.
    "mixed_obs_shapes": (_mixed_obs, None, 2, True, None),
    "string_aux": (lambda: _aux_variant({"note": "hello"}), None, 2, True, None),
    "mixed_aux_keys": (lambda: _aux_variant({"v": np.float32(1.0)}), None, 2,
                       True, None),
    "garbage": (lambda: b"definitely not msgpack", None, 2, True, None),
    "wrong_wire_version": (lambda: __import__("msgpack").packb(
        {"v": 99, "acts": []}), None, 2, True, None),
}


def _same_decode(got, want):
    assert type(got).__name__ == type(want).__name__
    if isinstance(got, columnar.RawTrajectory):
        assert (got.agent_id, got.payload, got.is_envelope) == \
            (want.agent_id, want.payload, want.is_envelope)
        return
    for field in ("agent_id", "n_steps", "n_records", "marker_truncated"):
        assert getattr(got, field) == getattr(want, field), field
    for field in ("final_obs", "final_mask"):
        a, b = getattr(got, field), getattr(want, field)
        assert (a is None) == (b is None), field
        if a is not None:
            np.testing.assert_array_equal(a, b)
    for attr in ("columns", "aux"):
        a, b = getattr(got, attr), getattr(want, attr)
        assert a.keys() == b.keys(), attr
        for key in a:
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("case", list(PAYLOADS))
@pytest.mark.parametrize("envelope", [False, True], ids=["bare", "envelope"])
def test_decoder_matches_jax_and_python(case, envelope, jax_native):
    make, obs_dim, act_dim, discrete, horizon = PAYLOADS[case]
    made = make()
    payload = made if isinstance(made, bytes) else serialize_actions(made)
    wire = pack_trajectory_envelope("agent-xyz", payload) if envelope else payload
    got = columnar.NativeDecoder().decode(wire, agent_id="parity",
                                          has_envelope=envelope)
    want = jax_columnar.NativeDecoder().decode(wire, agent_id="parity",
                                               has_envelope=envelope)
    _same_decode(got, want)
    if obs_dim is None or isinstance(made, bytes):
        if case in ("mixed_obs_shapes", "string_aux", "mixed_aux_keys",
                    "garbage", "wrong_wire_version"):
            assert isinstance(got, columnar.RawTrajectory)
            raw = got.payload
            if got.is_envelope:
                raw = unpack_trajectory_envelope(raw)[1]
            assert raw == payload  # the Python decoder can take over
        return
    assert isinstance(got, columnar.DecodedTrajectory), got
    assert got.agent_id == ("agent-xyz" if envelope else "parity")
    assert got.n_records == len(made)
    folded, final_obs, truncated, _ = fold_trailing_markers(
        deserialize_actions(payload))
    assert got.n_steps == len(folded) and got.marker_truncated == truncated
    if got.n_steps == 0:
        return
    h = horizon or pick_bucket(len(made), (64, 256, 1000))
    py = pad_trajectory(deserialize_actions(payload), h, obs_dim, act_dim,
                        discrete)
    nat = pad_decoded(got, h, obs_dim, act_dim, discrete)
    for field in ("obs", "act", "act_mask", "rew", "val", "logp", "valid"):
        np.testing.assert_array_equal(getattr(nat, field), getattr(py, field),
                                      err_msg=field)
    assert (nat.length, nat.terminated, nat.last_val) == \
        (py.length, py.terminated, py.last_val)


# ---------------------------------------------------------------------------
# live native planes
# ---------------------------------------------------------------------------
def _config(tmp) -> str:
    path = os.path.join(str(tmp), "native_config.json")
    with open(path, "w") as f:
        json.dump(CONFIG, f)
    return path


def _wait(pred, what, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _spy_publish(transport) -> dict:
    """Record every blob a server transport publishes, by version."""
    published = {}
    publish = transport.publish_model

    def spy(version, blob, *a, **k):
        published.setdefault(int(version), []).append(bytes(blob))
        return publish(version, blob, *a, **k)

    transport.publish_model = spy
    return published


def _tap_models(agent) -> list:
    received = []
    deliver = agent.transport.on_model

    def tap(version, blob):
        received.append((int(version), bytes(blob)))
        deliver(version, blob)

    agent.transport.on_model = tap
    return received


def _drive(agent, rng, n, steps=5):
    for _ in range(n):
        for _ in range(steps):
            agent.request_for_action(rng.standard_normal(4).astype(np.float32))
        agent.flag_last_action(1.0, terminated=True)


def _port_server(tmp, config_path, port, **kw):
    from relayrl_tpu_torch.runtime.server import TrainingServer

    return TrainingServer("REINFORCE", obs_dim=4, act_dim=2,
                          env_dir=str(tmp), config_path=config_path,
                          hyperparams=dict(HP), device="cpu",
                          server_type="native",
                          bind_addr=f"127.0.0.1:{port}", **kw)


def _check_frames(received, published):
    assert received
    for version, blob in received:
        assert blob in published[version], version


def test_native_round_trip(tmp_cwd):
    from relayrl_tpu_torch.runtime.agent import VectorAgent
    from relayrl_tpu_torch.transport.native_bindings import (
        NativeAgentTransportImpl,
        NativeServerTransportImpl,
    )

    config_path, port = _config(tmp_cwd), free_port()
    server = _port_server(tmp_cwd, config_path, port)
    published = _spy_publish(server.transport)
    agent = None
    try:
        assert isinstance(server.transport, NativeServerTransportImpl)
        agent = VectorAgent(num_envs=2, config_path=config_path, seed=0,
                            server_type="auto", device="cpu",
                            server_addr=f"127.0.0.1:{port}")
        assert isinstance(agent.transport, NativeAgentTransportImpl)
        received = _tap_models(agent)
        rng = np.random.default_rng(0)
        for target in range(1, 5):
            for _ in range(5):
                agent.request_for_actions(
                    rng.standard_normal((2, 4)).astype(np.float32))
            for lane in range(2):
                agent.flag_last_action(lane, 1.0, terminated=True)
            _wait(lambda t=target: agent.model_version == t
                  == server.stats["updates"], f"version {target}")
        assert server.drain(timeout=30)
        version, digest = server.published_digest()
        assert version == 4
        assert tree_digest(params_to_jax(agent.host.params)) == digest
        _check_frames(received, published)
        assert server.decoded_by == {"native": 8, "python": 0, "columnar": 0}
        assert server.stats["learner_errors"] == 0
        acct = server.ingest_accounting()["agents"]
        for aid, sent in agent.spool.sent_counts().items():
            assert acct[aid] == {"max_seq": sent, "accepted": sent,
                                 "contiguous": True}
    finally:
        if agent is not None:
            agent.disable_agent()
        server.disable_server()


def test_port_agent_feeds_jax_native_server(tmp_cwd, jax_native):
    from relayrl_tpu.runtime.server import TrainingServer as JaxServer
    from relayrl_tpu_torch.runtime.agent import Agent

    config_path, port = _config(tmp_cwd), free_port()
    server = JaxServer("REINFORCE", obs_dim=4, act_dim=2,
                       env_dir=str(tmp_cwd), config_path=config_path,
                       hyperparams=dict(HP), server_type="native",
                       bind_addr=f"127.0.0.1:{port}")
    published = _spy_publish(server.transport)
    agent = None
    try:
        agent = Agent(config_path=config_path, seed=0, server_type="native",
                      device="cpu", server_addr=f"127.0.0.1:{port}")
        received = _tap_models(agent)
        rng = np.random.default_rng(0)
        for target in range(1, 4):
            _drive(agent, rng, 2)
            _wait(lambda t=target: agent.model_version == t,
                  f"version {target}")
        server.drain(timeout=30)
        _check_frames(received, published)
        assert tree_digest(params_to_jax(agent.actor.params)) == \
            tree_digest(jax.device_get(server.algorithm.state.params))
        acct = server.ingest_accounting()["agents"]
        for aid, sent in agent.spool.sent_counts().items():
            assert acct[aid] == {"max_seq": sent, "accepted": sent,
                                 "contiguous": True}
    finally:
        if agent is not None:
            agent.disable_agent()
        server.disable_server()


def test_jax_native_agent_feeds_port_server(tmp_cwd, jax_native):
    from relayrl_tpu.runtime.agent import Agent as JaxAgent

    config_path, port = _config(tmp_cwd), free_port()
    server = _port_server(tmp_cwd, config_path, port)
    published = _spy_publish(server.transport)
    agent = None
    try:
        agent = JaxAgent(config_path=config_path, seed=0,
                         server_type="native",
                         server_addr=f"127.0.0.1:{port}")
        received = _tap_models(agent)
        rng = np.random.default_rng(0)
        for target in range(1, 4):
            _drive(agent, rng, 2)
            _wait(lambda t=target: agent.model_version == t,
                  f"version {target}")
        assert server.drain(timeout=30)
        _check_frames(received, published)
        version, digest = server.published_digest()
        assert tree_digest(jax.device_get(agent.actor.params)) == digest
        assert server.decoded_by["native"] == 6
        assert server.decoded_by["python"] == 0
    finally:
        if agent is not None:
            agent.disable_agent()
        server.disable_server()


# ---------------------------------------------------------------------------
# transport resolution against the JAX package's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("library", [True, False], ids=["library", "none"])
def test_resolution_matches_jax(library, tmp_cwd, jax_native, monkeypatch):
    import relayrl_tpu.transport.native_backend as jax_backend
    import relayrl_tpu_torch.transport.native_backend as port_backend
    from relayrl_tpu.config import ConfigLoader as JaxConfig
    from relayrl_tpu.transport import make_server_transport as jax_make
    from relayrl_tpu_torch.config import ConfigLoader
    from relayrl_tpu_torch.transport import make_server_transport

    if not library:
        monkeypatch.setattr(jax_backend, "native_available",
                            lambda build=True: False)
        monkeypatch.setattr(port_backend, "native_available",
                            lambda build=True: False)
    config_path = _config(tmp_cwd)
    cases = [("auto", {}), ("grpc", {}), ("grpc", {"native_grpc": False}),
             ("native", {}), ("zmq", {})]
    if not library:
        cases.remove(("native", {}))
    names = {}
    for pkg, make, cfg in (("jax", jax_make, JaxConfig(None, config_path)),
                           ("port", make_server_transport,
                            ConfigLoader(None, config_path))):
        names[pkg] = []
        for server_type, extra in cases:
            ports = [free_port() for _ in range(3)]
            addrs = ({"bind_addr": f"127.0.0.1:{ports[0]}"}
                     if server_type != "zmq" else
                     {"agent_listener_addr": f"tcp://127.0.0.1:{ports[0]}",
                      "trajectory_addr": f"tcp://127.0.0.1:{ports[1]}",
                      "model_pub_addr": f"tcp://127.0.0.1:{ports[2]}"})
            if server_type == "auto":
                addrs.update({
                    "agent_listener_addr": f"tcp://127.0.0.1:{ports[1]}",
                    "trajectory_addr": f"tcp://127.0.0.1:{ports[2]}",
                    "model_pub_addr": f"tcp://127.0.0.1:{free_port()}"})
            transport = make(server_type, cfg, **addrs, **extra)
            names[pkg].append(type(transport).__name__.replace("Impl", ""))
            del transport
    assert names["port"] == names["jax"]
    want = (["NativeServerTransport", "NativeGrpcServerTransport",
             "GrpcServerTransport", "NativeServerTransport",
             "ZmqServerTransport"] if library else
            ["ZmqServerTransport", "GrpcServerTransport",
             "GrpcServerTransport", "ZmqServerTransport"])
    assert names["port"] == want


def test_agent_auto_negotiates_like_jax(tmp_cwd, jax_native):
    """Against a live port native server, both packages' agents resolve
    ``auto`` to native."""
    from relayrl_tpu.config import ConfigLoader as JaxConfig
    from relayrl_tpu.transport import make_agent_transport as jax_make
    from relayrl_tpu_torch.config import ConfigLoader
    from relayrl_tpu_torch.transport import make_agent_transport

    config_path, port = _config(tmp_cwd), free_port()
    server = _port_server(tmp_cwd, config_path, port)
    try:
        got = make_agent_transport("auto", ConfigLoader(None, config_path),
                                   server_addr=f"127.0.0.1:{port}")
        want = jax_make("auto", JaxConfig(None, config_path),
                        server_addr=f"127.0.0.1:{port}")
        assert type(got).__name__ == type(want).__name__ == \
            "NativeAgentTransportImpl"
        got.close()
        want.close()
    finally:
        server.disable_server()


# ---------------------------------------------------------------------------
# the decoded drain's guardrail funnel against the JAX server's
# ---------------------------------------------------------------------------
def test_decoded_drain_verdicts_match_jax(tmp_path, monkeypatch, jax_native):
    import relayrl_tpu.runtime.server as jax_srv_mod
    import relayrl_tpu_torch.transport as port_transport
    from relayrl_tpu_torch.runtime.server import TrainingServer
    from tests.test_torch_guardrails import (
        ACT_DIM,
        OBS_DIM,
        PKGS,
        SERVER_HP,
        StubTransport,
        _guard_counters,
        _stream,
        _write_config,
    )

    decoders = {"jax": jax_columnar.NativeDecoder(),
                "port": columnar.NativeDecoder()}
    servers, verdicts = {}, {}
    try:
        for pkg in ("jax", "port"):
            work = tmp_path / pkg
            work.mkdir()
            monkeypatch.chdir(work)
            tel = PKGS[pkg]["telemetry"]
            tel.set_registry(tel.Registry(run_id=f"drain-{pkg}"))
            stub = StubTransport()
            mod = jax_srv_mod if pkg == "jax" else port_transport
            monkeypatch.setattr(mod, "make_server_transport",
                                lambda *a, s=stub, **k: s)
            config = _write_config(
                work, guardrails={"strike_threshold": 2, "max_steps": 8,
                                  "quarantine_cooldown_s": 300})
            kw = {"device": "cpu"} if pkg == "port" else {}
            cls = jax_srv_mod.TrainingServer if pkg == "jax" else TrainingServer
            srv = servers[pkg] = cls(
                "REINFORCE", obs_dim=OBS_DIM, act_dim=ACT_DIM,
                env_dir=str(work), config_path=config,
                hyperparams=dict(SERVER_HP), **kw)
            assert stub.on_trajectory_decoded == srv._on_trajectory_decoded
            srv.wait_warmup(120)
            cmod = PKGS[pkg]["columnar"]
            trace = []
            for agent, payload in _stream(pkg):
                if cmod.is_columnar_frame(payload):
                    item = cmod.parse_frame(payload, agent_id=agent)
                else:
                    item = decoders[pkg].decode(payload, agent_id=agent)
                assert isinstance(item, cmod.DecodedTrajectory)
                srv._on_trajectory_decoded([item])
                trace.append((agent, srv.guardrails.quarantine
                              .is_quarantined(agent.split("#")[0])))
            # A replayed seq is deduped on this path too.
            srv._on_trajectory_decoded([decoders[pkg].decode(
                _stream(pkg)[0][1], agent_id="good#s1")])
            assert srv.drain(timeout=120)
            verdicts[pkg] = (trace, srv.guardrails_accounting(),
                             _guard_counters(tel),
                             srv.stats["trajectories"],
                             srv.algorithm.version,
                             srv.ingest_accounting())
        assert verdicts["port"] == verdicts["jax"]
        trace, acct, counters, trajectories, version, ingest = verdicts["port"]
        assert acct["quarantine"]["quarantined"] == ["nan", "shape"]
        assert counters["relayrl_guard_quarantine_rejects_total{}"] == 3
        assert (trajectories, version) == (6, 3)
        assert ingest["duplicates"] == 1
        # Past the dedup ledger: the replayed seq is not counted.
        assert servers["port"].decoded_by["native"] == len(_stream("port"))
    finally:
        for srv in servers.values():
            srv.disable_server()
