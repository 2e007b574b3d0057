"""The port's distributed tracing (``relayrl_tpu_torch/telemetry/trace.py``)
held to the JAX package's (``relayrl_tpu/telemetry/trace.py``).

* The wire context and tagged envelope ids are byte-equal; the version
  sampler gives the same verdict for versions 0-9999 at three rates; the
  analyzer, its text report and the Chrome-trace export are equal on the
  same seeded span lists (cross-host skew pairs included); each
  package's journal loads in the other's ``load_spans``; the port's
  ``/traces`` serves its live ring.
* One live ZMQ drill: a traced port ``Agent`` feeds a port
  ``TrainingServer`` through a port ``RelayNode`` on the CPU. Every
  trajectory the server trained on has a complete upstream trace (the
  JAX package's ``TRAJ_HOPS``, relay included) with monotonic hop starts
  and no overlap inside a plane, every published version its model trace,
  every age lies in ``[0, 300 s)`` with one observation per trace, and the
  trace-side version lag matches ``relayrl_rlhf_train_lag_versions``. The
  same loop untraced from the same seeds ships the same trajectory bytes,
  publishes the same frames and bundle, and ends at the same params; only
  the ``#t`` suffix of the envelope ids differs.
* Interop: a traced JAX ``Agent`` feeds a port server, and a traced port
  ``Agent`` feeds a JAX server; the receiving side records ingest, dedup,
  staging and update under the sender's trace ids.

Models are ``mlp_discrete`` 16x16 with 3 value iterations on the CPU.
"""

from __future__ import annotations

import json
import os
import time
import urllib.request

import numpy as np
import pytest

from relayrl_tpu import telemetry as jax_telemetry
from relayrl_tpu.telemetry import trace as jax_trace
from relayrl_tpu_torch import telemetry
from relayrl_tpu_torch.telemetry import trace
from tests._util import free_port

HP = {"traj_per_epoch": 2, "hidden_sizes": [16, 16], "train_vf_iters": 3,
      "with_vf_baseline": True, "bucket_lengths": [16], "seed_salt": 0}
CONFIG = {"guardrails": {"enabled": False},
          "transport": {"small_model_bytes": 0, "keyframe_interval": 3}}
EPOCHS = 3
UPSTREAM = ("env", "encode", "send", "relay", "ingest", "dedup", "staging",
            "update")
MODEL = ("dispatch", "fence", "encode", "publish", "relay", "receipt",
         "swap")


@pytest.fixture(autouse=True)
def _clean_telemetry():
    for mod in (telemetry, jax_telemetry):
        mod.reset_for_tests()
    yield
    for mod in (telemetry, jax_telemetry):
        mod.reset_for_tests()


def _seeded_spans(seed: int) -> list[dict]:
    """Trajectory and model traces with random stamps; every fifth
    trajectory's env stamp comes from another host (400 s ahead)."""
    rng = np.random.default_rng(seed)
    spans = []
    for k in range(12):
        tid, base, t = f"{k:x}-{k + 1:x}", int(rng.integers(1, 10**9)), 0
        for hop in jax_trace.TRAJ_HOPS:
            if hop == "relay" and k % 3:
                continue
            dur = int(rng.integers(0, 50_000))
            s = {"kind": "traj", "trace": tid, "hop": hop,
                 "proc": "actor" if hop in ("env", "encode", "send")
                 else "server", "t0_ns": base + t, "t1_ns": base + t + dur}
            if hop == "env":
                s["version"] = int(rng.integers(0, 4))
                if k % 5 == 0:
                    s["t0_ns"] += int(400e9)
                    s["t1_ns"] += int(400e9)
            if hop == "update":
                s["version"] = int(rng.integers(4, 8))
            spans.append(s)
            t += dur + int(rng.integers(0, 10_000))
    for v in range(1, 6):
        base, t = int(rng.integers(1, 10**9)), 0
        for hop in jax_trace.MODEL_HOPS:
            dur = int(rng.integers(0, 80_000))
            s = {"kind": "model", "trace": f"v{v}", "hop": hop,
                 "proc": "server", "t0_ns": base + t, "t1_ns": base + t + dur,
                 "version": v}
            if hop == "swap":
                s["actor"] = f"a{v % 2}"
                if v == 3:
                    s["t1_ns"] -= int(400e9)
            spans.append(s)
            t += dur
    spans.append({"kind": "serve", "trace": "serve-1-1", "hop": "queue",
                  "proc": "server", "t0_ns": 5, "t1_ns": 9, "agent": "c"})
    return spans


def test_hop_vocabulary_and_skew_guard_match():
    assert trace.TRAJ_HOPS == jax_trace.TRAJ_HOPS == UPSTREAM
    assert trace.MODEL_HOPS == jax_trace.MODEL_HOPS == MODEL
    assert trace.SERVE_HOPS == jax_trace.SERVE_HOPS
    assert trace.RLHF_HOPS == jax_trace.RLHF_HOPS
    assert trace.SKEW_GUARD_NS == jax_trace.SKEW_GUARD_NS == int(300e9)


def test_context_and_tagged_ids_byte_equal():
    from relayrl_tpu.transport.base import tag_agent_seq as jax_tag_seq
    from relayrl_tpu_torch.transport.base import tag_agent_seq

    rng = np.random.default_rng(0)
    for k in range(200):
        trace_id = f"{int(rng.integers(1, 2**31)):x}-{k + 1:x}"
        born_ns = int(rng.integers(0, 2**62))
        born_version = int(rng.integers(-1, 2**40))
        mine = trace.TrajCtx(trace_id, born_ns, born_version)
        ref = jax_trace.TrajCtx(trace_id, born_ns, born_version)
        assert mine.encode() == ref.encode()
        agent = f"agent-{k}.lane{k % 8}"
        tagged = tag_agent_seq(trace.tag_agent_trace(agent, mine.encode()), k)
        assert tagged == jax_tag_seq(
            jax_trace.tag_agent_trace(agent, ref.encode()), k)
        base = tagged.rpartition("#s")[0]
        clean, got = trace.split_ctx(base)
        jclean, jgot = jax_trace.split_ctx(base)
        assert clean == jclean == agent
        assert (got.trace_id, got.born_ns, got.born_version) == (
            jgot.trace_id, jgot.born_ns, jgot.born_version)
    for bad in ("a#tzz.1.2", "a#t1.2", "a#t.1.2", "plain"):
        assert trace.split_ctx(bad) == (bad, None) == jax_trace.split_ctx(bad)


@pytest.mark.parametrize("rate", [0.01, 0.1, 0.5])
def test_sample_version_verdicts_equal(rate):
    mine = trace.Tracer(rate, journal=False)
    ref = jax_trace.Tracer(rate, journal=False)
    verdicts = [mine.sample_version(v) for v in range(10_000)]
    assert verdicts == [ref.sample_version(v) for v in range(10_000)]
    assert not verdicts[0]
    assert abs(sum(verdicts) / 10_000 - rate) < 0.2 * rate + 0.005


def test_stride_sampling_and_null_tracer():
    mine = trace.Tracer(0.25, journal=False)
    ref = jax_trace.Tracer(0.25, journal=False)
    draws = [mine.sample_traj(10, 1) is not None for _ in range(40)]
    assert draws == [ref.sample_traj(10, 1) is not None for _ in range(40)]
    assert sum(draws) == 10
    assert trace.get_tracer() is trace.NULL_TRACER
    assert trace.configure(0.0) is trace.NULL_TRACER
    doc = trace.traces_document()
    assert doc == jax_trace.traces_document()
    assert doc["enabled"] is False and doc["spans"] == []


@pytest.mark.parametrize("seed", [0, 1])
def test_analyzer_report_and_chrome_trace_equal(seed):
    spans = _seeded_spans(seed)
    report = trace.analyze(spans)
    assert report == jax_trace.analyze(spans)
    assert report["skew_dropped"] >= 3
    assert trace.render_report(report) == jax_trace.render_report(report)
    assert trace.to_chrome_trace(spans) == jax_trace.to_chrome_trace(spans)


def _journal_spans(mod, tmod, path: str, spans: list[dict]) -> None:
    from importlib import import_module

    events = import_module(mod.__name__ + ".events")
    mod.set_registry(mod.Registry(run_id="journal"))
    mod.set_journal(events.EventJournal(path, run_id="journal"))
    tracer = tmod.configure(1.0, journal=True)
    for s in spans:
        tracer.span(s["kind"], s["trace"], s["hop"], s["t0_ns"], s["t1_ns"],
                    **{k: v for k, v in s.items()
                       if k not in ("kind", "trace", "hop", "proc", "t0_ns",
                                    "t1_ns")})
    mod.get_journal().close()


def test_journals_load_in_the_other_package(tmp_path):
    spans = _seeded_spans(2)
    mine, ref = str(tmp_path / "port.ndjson"), str(tmp_path / "jax.ndjson")
    _journal_spans(telemetry, trace, mine, spans)
    _journal_spans(jax_telemetry, jax_trace, ref, spans)

    def core(ss):
        return sorted((s["kind"], s["trace"], s["hop"], s["t0_ns"],
                       s["t1_ns"]) for s in ss)

    for path in (mine, ref):
        got, want = trace.load_spans([path]), jax_trace.load_spans([path])
        assert got == want
        assert core(got) == core(spans)
        assert trace.analyze(got) == jax_trace.analyze(want)


def test_traces_endpoint_serves_the_live_ring():
    from relayrl_tpu_torch.telemetry.export import TelemetryExporter

    reg = telemetry.Registry(run_id="remote")
    telemetry.set_registry(reg)
    tracer = trace.configure(1.0, journal=False)
    tracer.span("model", "v1", "swap", 0, 1000, version=1)
    exporter = TelemetryExporter(reg, port=0)
    try:
        with urllib.request.urlopen(exporter.url + "/traces",
                                    timeout=5) as resp:
            doc = json.loads(resp.read().decode())
    finally:
        exporter.close()
    assert doc == json.loads(json.dumps(trace.traces_document()))
    assert doc["schema"] == "relayrl-trace-v1" and doc["enabled"]
    assert [(s["hop"], s["version"]) for s in doc["spans"]] == [("swap", 1)]


# -- live loops ---------------------------------------------------------------

def _addrs():
    ports = [free_port() for _ in range(3)]
    server = {"agent_listener_addr": f"tcp://127.0.0.1:{ports[0]}",
              "trajectory_addr": f"tcp://127.0.0.1:{ports[1]}",
              "model_pub_addr": f"tcp://127.0.0.1:{ports[2]}"}
    agent = {"agent_listener_addr": server["agent_listener_addr"],
             "trajectory_addr": server["trajectory_addr"],
             "model_sub_addr": server["model_pub_addr"]}
    return server, agent


def _config(tmp) -> str:
    path = os.path.join(str(tmp), "trace_config.json")
    with open(path, "w") as f:
        json.dump(CONFIG, f)
    return path


def _drive(agent, rng, n, steps=5):
    for _ in range(n):
        for _ in range(steps):
            agent.request_for_action(rng.standard_normal(4).astype(np.float32))
        agent.flag_last_action(1.0, terminated=True)


def _wait(pred, what, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _loop(tmp, traced: bool) -> dict:
    """A port Agent -> port RelayNode -> port TrainingServer over ZMQ, one
    epoch at a time (each epoch played under the version the previous one
    published, so two runs from the same seeds see the same models)."""
    from relayrl_tpu_torch.relay import RelayNode
    from relayrl_tpu_torch.runtime.agent import Agent
    from relayrl_tpu_torch.runtime.server import TrainingServer
    from relayrl_tpu_torch.weights import params_to_jax, tree_digest

    telemetry.reset_for_tests()
    telemetry.set_registry(telemetry.Registry(run_id="drill"))
    if traced:
        trace.configure(1.0, ring=8192, journal=False)
    run = os.path.join(str(tmp), "traced" if traced else "plain")
    os.makedirs(run)
    config_path = _config(run)
    server_addrs, relay_up = _addrs()
    relay_down, agent_addrs = _addrs()
    server = TrainingServer("REINFORCE", obs_dim=4, act_dim=2, env_dir=run,
                            config_path=config_path, hyperparams=dict(HP),
                            device="cpu", start=False, **server_addrs)
    # Rate 0 (the default): the shared null tracer stays installed.
    assert (trace.get_tracer() is trace.NULL_TRACER) is not traced
    received, published = [], []
    ingest = server.transport.on_trajectory
    server.transport.on_trajectory = lambda aid, p: (
        received.append((aid, bytes(p))), ingest(aid, p))
    publish = server._faulted_publish
    server._faulted_publish = lambda v, frame, **kw: (
        published.append((int(v), bytes(frame))), publish(v, frame, **kw))
    server.enable_server()
    relay = agent = None
    try:
        relay = RelayNode(config_path=config_path, name="relay-t",
                          upstream_type="zmq",
                          upstream={**relay_up, "probe": False},
                          downstream_type="zmq", downstream=relay_down,
                          batch_max=1)
        agent = Agent(config_path=config_path, seed=3, probe=False,
                      device="cpu", model_path=os.path.join(run, "c.rlx"),
                      **agent_addrs)
        rng = np.random.default_rng(7)
        for target in range(1, EPOCHS + 1):
            _drive(agent, rng, HP["traj_per_epoch"])
            _wait(lambda t=target: agent.model_version == t,
                  f"the agent to install version {target}")
        assert server.drain(timeout=30)
        out = {"received": received, "published": published,
               "bundle": server._get_model(),
               "digest": server.published_digest(),
               "agent_digest": tree_digest(params_to_jax(agent.actor.params)),
               "stats": dict(server.stats),
               "actor": f"{id(agent.actor):x}"}
    finally:
        if agent is not None:
            agent.disable_agent()
        if relay is not None:
            relay.close(flush_timeout_s=5)
        server.disable_server()
    out["spans"] = trace.snapshot_spans()
    out["snapshot"] = telemetry.get_registry().snapshot()
    return out


def admitted_hops(spans: list[dict]) -> dict[str, dict]:
    """Trajectory trace id -> {hop: span}, keeping of the server's ingest
    and dedup spans the arrival the dedup ledger admitted (a redelivery
    records an ingest and an admitted-false dedup of its own)."""
    traj: dict[str, dict] = {}
    arrivals: dict[str, list] = {}
    for s in spans:
        if s["kind"] != "traj":
            continue
        if s["hop"] in ("ingest", "dedup"):
            arrivals.setdefault(s["trace"], []).append(s)
            continue
        assert s["hop"] not in traj.setdefault(s["trace"], {}), s
        traj[s["trace"]][s["hop"]] = s
    for tid, ss in arrivals.items():
        ingests = sorted((s for s in ss if s["hop"] == "ingest"),
                         key=lambda s: s["t0_ns"])
        dedups = sorted((s for s in ss if s["hop"] == "dedup"),
                        key=lambda s: s["t0_ns"])
        kept = [(i, d) for i, d in zip(ingests, dedups) if d["admitted"]]
        assert len(ingests) == len(dedups) and len(kept) == 1, ss
        traj.setdefault(tid, {}).update(ingest=kept[0][0], dedup=kept[0][1])
    return traj


def first_arrivals(received: list) -> list:
    """(seq, payload) of each sequence number's first arrival, in arrival
    order (the agent's identity is drawn anew in every run)."""
    from relayrl_tpu_torch.transport.base import split_agent_seq

    seen, out = set(), []
    for aid, payload in received:
        base, seq = split_agent_seq(aid)
        key = (trace.split_ctx(base)[0], seq)
        if key not in seen:
            seen.add(key)
            out.append((seq, payload))
    return out


def _metric(snapshot: dict, name: str) -> dict:
    return next(m for m in snapshot["metrics"] if m["name"] == name)


def test_live_traced_loop_through_a_relay_and_untraced_twin(tmp_cwd):
    from relayrl_tpu_torch.transport.base import split_agent_seq

    traced = _loop(tmp_cwd, traced=True)
    plain = _loop(tmp_cwd, traced=False)
    spans = traced["spans"]
    trained = traced["stats"]["trajectories"]
    assert trained == EPOCHS * HP["traj_per_epoch"]

    # Every trajectory the server trained on: the full upstream hop set,
    # starts in causal order, no overlap inside the actor's or the
    # server's chain. The relay spool's closing flush redelivers its
    # window: those arrivals dedup (admitted false) and are set aside.
    traj = admitted_hops(spans)
    assert len(traj) == trained
    for hops in traj.values():
        assert tuple(h for h in UPSTREAM if h in hops) == UPSTREAM
        assert set(hops) == set(UPSTREAM)
        assert all(hops[a]["t0_ns"] <= hops[b]["t0_ns"]
                   for a, b in zip(UPSTREAM, UPSTREAM[1:]))
        for chain in (("env", "encode", "send"),
                      ("ingest", "dedup", "staging", "update")):
            assert all(hops[a]["t1_ns"] <= hops[b]["t0_ns"]
                       for a, b in zip(chain, chain[1:]))
        assert hops["relay"]["relay"] == "relay-t"

    # Every published version: its downstream trace, receipts at the
    # relay's upstream and at the agent, the swap on the agent's actor.
    versions = sorted({v for v, _ in traced["published"]})
    assert versions == list(range(1, EPOCHS + 1))
    model: dict[str, list] = {}
    for s in spans:
        if s["kind"] == "model":
            model.setdefault(s["trace"], []).append(s)
    assert sorted(model) == sorted(trace.model_trace_id(v) for v in versions)
    for ss in model.values():
        assert {s["hop"] for s in ss} == set(MODEL)
        assert sum(s["hop"] == "receipt" for s in ss) == 2
        swaps = [s for s in ss if s["hop"] == "swap"]
        assert [s["actor"] for s in swaps] == [traced["actor"]]

    # Ages: one observation per trace (the model age once at the relay's
    # receipt and once at the agent's), all inside the skew guard.
    report = trace.analyze(spans)
    ages = report["trajectories"]["data_age_s"]
    assert ages["count"] == trained and 0 <= ages["max"] < 300
    assert 0 <= report["models"]["model_age_s"]["max"] < 300
    snap = traced["snapshot"]
    data_age = _metric(snap, "relayrl_trace_data_age_seconds")
    model_age = _metric(snap, "relayrl_trace_model_age_seconds")
    assert data_age["count"] == trained
    assert model_age["count"] == 2 * len(versions)
    assert 0 <= data_age["sum"] and 0 <= model_age["sum"]
    lag = _metric(snap, "relayrl_rlhf_train_lag_versions")
    assert lag["count"] == trained
    trace_mean = report["trajectories"]["data_age_versions"]["mean"]
    assert abs(trace_mean - lag["sum"] / lag["count"]) <= 0.5

    # Tracing computes nothing differently: the same trajectory bytes,
    # frames, bundle and params, ids equal but for the #t suffix.
    assert plain["spans"] == []
    assert all(trace.split_ctx(split_agent_seq(aid)[0])[1] is not None
               for aid, _ in traced["received"])
    assert all(trace.split_ctx(split_agent_seq(aid)[0])[1] is None
               for aid, _ in plain["received"])
    assert first_arrivals(traced["received"]) == \
        first_arrivals(plain["received"])
    assert traced["published"] == plain["published"]
    assert traced["bundle"] == plain["bundle"]
    assert traced["digest"] == plain["digest"]
    assert traced["agent_digest"] == plain["agent_digest"] == \
        traced["digest"][1]


@pytest.mark.parametrize("direction", [
    "jax_agent_to_port_server",
    # The JAX server's first update compiles for seconds on the CPU.
    pytest.param("port_agent_to_jax_server", marks=pytest.mark.slow)])
def test_interop_traces_join_across_packages(direction, tmp_cwd):
    """The receiving package records ingest, dedup, staging and update
    under the trace ids the sending package minted."""
    from relayrl_tpu.runtime.agent import Agent as JaxAgent
    from relayrl_tpu.runtime.server import TrainingServer as JaxServer
    from relayrl_tpu_torch.runtime.agent import Agent
    from relayrl_tpu_torch.runtime.server import TrainingServer

    for mod, tmod in ((telemetry, trace), (jax_telemetry, jax_trace)):
        mod.set_registry(mod.Registry(run_id=direction))
        tmod.configure(1.0, journal=False)
    config_path = _config(tmp_cwd)
    server_addrs, agent_addrs = _addrs()
    jax_sends = direction == "jax_agent_to_port_server"
    if jax_sends:
        server = TrainingServer("REINFORCE", obs_dim=4, act_dim=2,
                                env_dir=str(tmp_cwd), config_path=config_path,
                                hyperparams=dict(HP), device="cpu",
                                **server_addrs)
    else:
        server = JaxServer("REINFORCE", obs_dim=4, act_dim=2,
                           env_dir=str(tmp_cwd), config_path=config_path,
                           hyperparams=dict(HP), **server_addrs)
    agent = None
    try:
        server.wait_warmup(timeout=120)
        if jax_sends:
            agent = JaxAgent(config_path=config_path, seed=0, probe=False,
                             **agent_addrs)
        else:
            agent = Agent(config_path=config_path, seed=0, probe=False,
                          device="cpu", **agent_addrs)
        rng = np.random.default_rng(5)
        for target in (1, 2):
            _drive(agent, rng, HP["traj_per_epoch"])
            _wait(lambda t=target: agent.model_version == t,
                  f"the agent to install version {target}")
        assert server.drain(timeout=30)
    finally:
        if agent is not None:
            agent.disable_agent()
        server.disable_server()
    sender, receiver = ((jax_trace, trace) if jax_sends
                        else (trace, jax_trace))
    sent = {s["trace"] for s in sender.snapshot_spans()
            if s["kind"] == "traj" and s["hop"] == "env"}
    got: dict[str, set] = {}
    for s in receiver.snapshot_spans():
        if s["kind"] == "traj":
            got.setdefault(s["trace"], set()).add(s["hop"])
    assert len(sent) == 2 * HP["traj_per_epoch"]
    assert set(got) == sent
    assert all(hops == {"ingest", "dedup", "staging", "update"}
               for hops in got.values())
