"""The port's fleet aggregation (``relayrl_tpu_torch/telemetry/aggregate.py``),
``top`` pane and actor metrics held to the JAX package's.

* Snapshot frames are byte-equal and each package parses the other's;
  ``merge_snapshots``, the ``FleetTable`` (restart folding, out-of-order
  drop, stale eviction, ``document``, ``prometheus_text``), the
  ``AlertEngine``'s fire and resolve sequence, and ``top``'s ``render``
  (the rlhf section included) and ``render_fleet`` text are equal on the
  same seeded inputs.
* A port relay's fan-in sends one merged upstream frame and never
  forwards a snapshot frame on the trajectory path.
* The actor metrics (``relayrl_actor_*`` and the epoch logger's
  ``relayrl_epoch_stat`` gauges) have the JAX package's names, labels and
  values after the same calls.
* One live ZMQ drill: a port ``VectorAgent`` in a process of its own
  feeds a port ``TrainingServer`` with the fleet plane on; the root's
  merged ``relayrl_actor_*`` counters equal the worker's own final
  registry bit for bit, ``/fleet`` lists both processes, ``top --fleet``
  renders the pane and no default alert fires.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from relayrl_tpu import telemetry as jax_telemetry
from relayrl_tpu.telemetry import aggregate as jax_ag
from relayrl_tpu.telemetry import top as jax_top
from relayrl_tpu_torch import telemetry
from relayrl_tpu_torch.telemetry import aggregate as ag
from relayrl_tpu_torch.telemetry import top
from tests._util import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ((telemetry, ag), (jax_telemetry, jax_ag))


@pytest.fixture(autouse=True)
def _clean_telemetry():
    for mod in (telemetry, jax_telemetry):
        mod.reset_for_tests()
    yield
    for mod in (telemetry, jax_telemetry):
        mod.reset_for_tests()


def _snapshot(seed: int, run_id: str) -> dict:
    """A registry snapshot with seeded counters, gauges (labelled
    children) and histograms, built by the JAX package's registry."""
    rng = np.random.default_rng(seed)
    reg = jax_telemetry.Registry(run_id=run_id)
    for name in ("relayrl_actor_env_steps_total", "relayrl_server_drops_total"):
        reg.counter(name).inc(float(rng.integers(0, 1000)))
    for lane in range(3):
        reg.gauge("relayrl_actor_lanes", labels={"host": str(lane)}).set(
            float(rng.integers(1, 64)))
    hist = reg.histogram("relayrl_trace_data_age_seconds",
                         buckets=(0.01, 0.1, 1.0, 10.0))
    for v in rng.exponential(0.5, size=int(rng.integers(1, 20))):
        hist.observe(float(v))
    return reg.snapshot()


def _sections(seed: int) -> list[dict]:
    return [{"proc": f"p{k}", "tier": ("actor", "relay", "server")[k % 3],
             "epoch": 1.0 + k, "seq": k + 1, "t_unix": 1e9 + k,
             "snapshot": _snapshot(seed * 10 + k, f"p{k}")}
            for k in range(4)]


@pytest.mark.parametrize("seed", [0, 1])
def test_snapshot_frames_byte_equal_and_cross_parse(seed):
    sections = _sections(seed)
    frame = ag.encode_snapshot_frame(sections)
    assert frame == jax_ag.encode_snapshot_frame(sections)
    assert frame[:4] == ag.SNAP_MAGIC == jax_ag.SNAP_MAGIC
    assert ag.parse_snapshot_frame(frame) == jax_ag.parse_snapshot_frame(frame)
    assert ag.fleet_wire_id("w-1") == jax_ag.fleet_wire_id("w-1")
    mine = ag.snapshot_section(sections[0]["snapshot"], "w", "bogus", 2.0, 3)
    ref = jax_ag.snapshot_section(sections[0]["snapshot"], "w", "bogus",
                                  2.0, 3)
    assert {**mine, "t_unix": 0} == {**ref, "t_unix": 0}
    for bad in (b"RLS1\x00", b"XXXX", ag.SNAP_MAGIC + b"\x81\xa1v\x09"):
        for mod in (ag, jax_ag):
            with pytest.raises(ValueError):
                mod.parse_snapshot_frame(bad)


def _timeless(doc: dict) -> dict:
    """A merged document without the wall-clock stamp of the merge."""
    return {k: v for k, v in doc.items() if k != "time_unix"}


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_snapshots_equal(seed):
    snaps = [s["snapshot"] for s in _sections(seed)]
    merged = ag.merge_snapshots(snaps)
    assert _timeless(merged) == _timeless(jax_ag.merge_snapshots(snaps))
    again = ag.merge_snapshots([ag.merge_snapshots(snaps[:2]),
                                ag.merge_snapshots(snaps[2:])])
    assert _timeless(again) == _timeless(jax_ag.merge_snapshots([
        jax_ag.merge_snapshots(snaps[:2]), jax_ag.merge_snapshots(snaps[2:])]))
    assert ag.snapshot_metric(merged, "relayrl_actor_env_steps_total") == \
        jax_ag.snapshot_metric(merged, "relayrl_actor_env_steps_total")


def test_fleet_table_sequence_equal():
    """Restarts fold, stale sections drop, silent procs evict: the same
    sequence through both tables leaves the same documents."""
    tables = [mod_ag.FleetTable(stale_s=5.0,
                                registry=mod.Registry(run_id="root"))
              for mod, mod_ag in PACKAGES]
    now = 1000.0
    seq = [(_sections(0), now), (_sections(1)[:2], now + 1)]
    restarted = [dict(s, epoch=s["epoch"] + 10, seq=1) for s in _sections(2)[:1]]
    stale = [dict(s, seq=0) for s in _sections(3)[1:2]]
    seq += [(restarted, now + 2), (stale, now + 3),
            (_sections(4)[2:3], now + 4)]
    for sections, t in seq:
        got = [table.ingest_sections(sections, now=t) for table in tables]
        assert got[0] == got[1]
    assert [table.sweep(now=now + 6.5) for table in tables] == \
        [["p1", "p3"]] * 2
    docs = []
    for table in tables:
        doc = table.document()
        doc.pop("time_unix")
        doc["procs"] = table.procs(now=now + 9)
        doc["merged"] = _timeless(doc["merged"])
        docs.append(doc)
    assert docs[0] == docs[1]
    assert [(p["proc"], p["restarts"]) for p in docs[0]["procs"]] == \
        [("p0", 1), ("p2", 0)]
    assert tables[0].prometheus_text() == tables[1].prometheus_text()
    for name in ("_m_stale_sections", "_m_restarts", "_m_evicted"):
        assert getattr(tables[0], name).total() == \
            getattr(tables[1], name).total() > 0


def test_alert_engine_fire_and_resolve_sequence_equal():
    rules = [r.describe() for r in jax_ag.default_alert_rules()]
    rules.append({"name": "steps", "metric": "relayrl_actor_env_steps_total",
                  "agg": "increase", "op": ">", "threshold": 50,
                  "for_s": 1.0})
    params = {"alerts": rules[-1:], "alerts_default_pack": True}
    assert [r.describe() for r in ag.rules_from_config(params)] == \
        [r.describe() for r in jax_ag.rules_from_config(params)]
    events = ([], [])
    engines = [mod_ag.AlertEngine(
        [mod_ag.AlertRule.from_dict(r) for r in rules],
        registry=mod.Registry(run_id="alerts"),
        emit=lambda ev, _out=out, **f: _out.append((ev, f)))
        for (mod, mod_ag), out in zip(PACKAGES, events)]
    rng = np.random.default_rng(3)
    steps = 0.0
    for t in range(12):
        steps += float(rng.integers(0, 120))
        merged = {"metrics": [
            {"name": "relayrl_actor_env_steps_total", "kind": "counter",
             "labels": {}, "value": steps},
            {"name": "relayrl_server_ingest_queue_depth", "kind": "gauge",
             "labels": {}, "value": float(rng.integers(0, 20_000))},
            {"name": "relayrl_server_dropped_total", "kind": "counter",
             "labels": {}, "value": float(t // 4)}]}
        for engine in engines:
            engine.evaluate(merged, now=float(t), membership=["a", "b"])
        assert engines[0].active() == engines[1].active()
        assert engines[0].describe() == engines[1].describe()
    assert events[0] == events[1]
    assert {ev for ev, _ in events[0]} == {"alert_fired", "alert_resolved"}


def test_top_render_and_fleet_pane_equal():
    snap = _snapshot(5, "top")
    snap["metrics"] += [
        {"name": "relayrl_rlhf_generated_tokens_total", "kind": "counter",
         "value": 1234, "labels": {}},
        {"name": "relayrl_rlhf_stage_seconds", "kind": "histogram",
         "labels": {"stage": "generate"}, "count": 10,
         "buckets": [0.1, 1.0], "counts": [5, 5, 0], "sum": 2.0}]
    prev = _snapshot(4, "top")
    text = top.render(snap, prev)
    assert text == jax_top.render(snap, prev)
    assert "-- rlhf" in text and "generated_tokens_total: 1.2k" in text
    assert "stage=generate" in text
    table = ag.FleetTable(registry=telemetry.Registry(run_id="root"))
    table.ingest_sections(_sections(6))
    engine = ag.AlertEngine(ag.default_alert_rules(),
                            registry=telemetry.Registry(run_id="a"))
    engine.evaluate(table.merged(), now=0.0)
    doc = table.document(alerts=engine)
    pane = top.render_fleet(doc)
    assert pane == jax_top.render_fleet(doc)
    assert "4 proc(s)" in pane and "-- actor " in pane
    entry = next(m for m in doc["merged"]["metrics"]
                 if m["name"] == "relayrl_trace_data_age_seconds")
    assert top.histogram_quantile(entry, 0.95) == \
        jax_top.histogram_quantile(entry, 0.95)


def test_relay_fan_in_sends_one_merged_frame(tmp_cwd):
    from tests.test_torch_relay import _make_fakes

    from relayrl_tpu_torch.relay import RelayNode

    telemetry.set_registry(telemetry.Registry(run_id="relay"))
    path = os.path.join(str(tmp_cwd), "fleet.json")
    with open(path, "w") as f:
        json.dump({"telemetry": {"fleet_interval_s": 30.0}}, f)
    FakeUp, FakeDown = _make_fakes()
    up = FakeUp()
    node = RelayNode(config_path=path, name="relay-t", batch_max=1,
                     spool_entries=0, upstream_transport=up,
                     downstream_transport=FakeDown())
    try:
        leaves = _sections(7)[:2]
        for sec in leaves:
            frame = ag.encode_snapshot_frame([sec])
            node._on_subtree_trajectory(ag.fleet_wire_id(sec["proc"]), frame)
        node._on_subtree_trajectory("w1#s1", b"real-payload")
        assert up.sent == [("w1#s1", b"real-payload")]
        node._fleet_flush()
        fleet = [(wid, p) for wid, p in up.sent if ag.is_snapshot_frame(p)]
        assert len(fleet) == 1 and fleet[0][0] == ag.fleet_wire_id("relay-t")
        sections = jax_ag.parse_snapshot_frame(fleet[0][1])
        assert [s["proc"] for s in sections] == ["p0", "p1", "relay-t"]
        assert sections[:2] == leaves
        assert sections[2]["tier"] == "relay"
        node._fleet_flush()
        assert [s["proc"] for s in ag.parse_snapshot_frame(up.sent[-1][1])] \
            == ["relay-t"]
    finally:
        node.close()


def _actor_rows(snapshot: dict) -> list:
    rows = []
    for m in snapshot["metrics"]:
        if not (m["name"].startswith("relayrl_actor_")
                or m["name"] == "relayrl_epoch_stat"):
            continue
        value = m["count"] if m["kind"] == "histogram" else m["value"]
        rows.append((m["name"], m["kind"], sorted(m["labels"].items()), value))
    return sorted(rows)


def test_actor_metrics_match_jax(tmp_path):
    import torch

    from relayrl_tpu.runtime.policy_actor import PolicyActor as JaxPolicyActor
    from relayrl_tpu.runtime.vector_actor import (
        VectorActorHost as JaxVectorActorHost,
    )
    from relayrl_tpu.types.model_bundle import ModelBundle as JaxModelBundle
    from relayrl_tpu.utils.logger import EpochLogger as JaxEpochLogger
    from relayrl_tpu_torch.models import build_policy
    from relayrl_tpu_torch.runtime import PolicyActor, VectorActorHost
    from relayrl_tpu_torch.types import ModelBundle
    from relayrl_tpu_torch.utils.logger import EpochLogger
    from relayrl_tpu_torch.weights import params_to_jax

    arch = {"kind": "mlp_discrete", "obs_dim": 4, "act_dim": 2,
            "hidden_sizes": [8]}
    policy = build_policy(arch, "cpu")
    params = [params_to_jax(policy.init_params(
        torch.Generator().manual_seed(k))) for k in range(2)]
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((6, 3, 4)).astype(np.float32)
    snaps = []
    for (mod, _), Bundle, Actor, Host, Logger in (
            (PACKAGES[0], ModelBundle, PolicyActor, VectorActorHost,
             EpochLogger),
            (PACKAGES[1], JaxModelBundle, JaxPolicyActor, JaxVectorActorHost,
             JaxEpochLogger)):
        mod.set_registry(mod.Registry(run_id="actors"))
        kw = ({"device": "cpu"} if Actor is PolicyActor
              else {"validate": False})
        actor = Actor(Bundle(1, dict(arch), params[0]), **kw)
        host = Host(Bundle(1, dict(arch), params[0]), 3, **kw)
        for k in range(6):
            actor.request_for_action(obs[k, 0])
            host.request_for_actions(obs[k])
            if k == 2:
                assert actor.maybe_swap(Bundle(2, dict(arch), params[1]))
                assert host.maybe_swap(Bundle(2, dict(arch), params[1]))
        logger = Logger(output_dir=str(tmp_path / mod.__name__))
        for epoch in range(2):
            logger.store(EpRet=[1.0 + epoch, 3.0])
            logger.log_tabular("Epoch", epoch)
            logger.log_tabular("EpRet", with_min_and_max=True)
            logger.dump_tabular()
        snaps.append(mod.get_registry().snapshot())
    rows = _actor_rows(snaps[0])
    assert rows == _actor_rows(snaps[1])
    names = {r[0] for r in rows}
    assert names == {"relayrl_actor_env_steps_total",
                     "relayrl_actor_batched_dispatches_total",
                     "relayrl_actor_lanes", "relayrl_actor_swap_seconds",
                     "relayrl_epoch_stat"}
    steps = next(r for r in rows if r[0] == "relayrl_actor_env_steps_total")
    assert steps[3] == 6 + 6 * 3


def _zmq_addrs():
    ports = [free_port() for _ in range(3)]
    server = {"agent_listener_addr": f"tcp://127.0.0.1:{ports[0]}",
              "trajectory_addr": f"tcp://127.0.0.1:{ports[1]}",
              "model_pub_addr": f"tcp://127.0.0.1:{ports[2]}"}
    agent = {"agent_listener_addr": server["agent_listener_addr"],
             "trajectory_addr": server["trajectory_addr"],
             "model_sub_addr": server["model_pub_addr"]}
    return server, agent


def test_live_root_totals_exact(tmp_cwd):
    from relayrl_tpu_torch.runtime.server import TrainingServer

    scratch = str(tmp_cwd)
    interval = 0.25
    config_path = os.path.join(scratch, "fleet_config.json")
    with open(config_path, "w") as f:
        json.dump({"guardrails": {"enabled": False},
                   "learner": {"checkpoint_dir": ""},
                   "telemetry": {"enabled": True, "port": 0,
                                 "fleet_interval_s": interval,
                                 "fleet_stale_s": 60.0}}, f)
    server_addrs, agent_addrs = _zmq_addrs()
    server = TrainingServer(
        "REINFORCE", obs_dim=4, act_dim=2, env_dir=scratch,
        config_path=config_path, device="cpu",
        hyperparams={"traj_per_epoch": 2, "hidden_sizes": [16, 16],
                     "train_vf_iters": 3, "bucket_lengths": [16],
                     "seed_salt": 0}, **server_addrs)
    worker = None
    try:
        assert server._fleet is not None and server._exporter is not None
        cfg = {"config_path": config_path, "identity": "drill-w0",
               "lanes": 2, "seed": 0,
               "ready_path": os.path.join(scratch, "ready"),
               "stop_path": os.path.join(scratch, "stop"),
               "result_path": os.path.join(scratch, "worker.json"),
               **agent_addrs}
        worker = subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests",
                                          "_torch_fleet_worker.py"),
             json.dumps(cfg)], cwd=scratch,
            env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        deadline = time.monotonic() + 120
        while not os.path.exists(cfg["ready_path"]):
            assert worker.poll() is None, worker.communicate()[0][-3000:]
            assert time.monotonic() < deadline
            time.sleep(0.05)
        while server.stats["updates"] < 2:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        time.sleep(4 * interval)  # a few live frames
        with open(cfg["stop_path"], "w") as f:
            f.write("stop")
        out, _ = worker.communicate(timeout=120)
        assert worker.returncode == 0, out[-3000:]
        with open(cfg["result_path"]) as f:
            final = json.load(f)["snapshot"]
        deadline = time.monotonic() + 30
        want = {}
        for m in final["metrics"]:
            if m["kind"] == "counter" and m["name"].startswith("relayrl_actor_"):
                want[(m["name"], tuple(sorted(m["labels"].items())))] = \
                    m["value"]
        assert len(want) >= 2

        def merged_actor_counters():
            server._fleet_tick()
            got = {}
            for m in server._fleet.merged()["metrics"]:
                key = (m["name"], tuple(sorted(m["labels"].items())))
                if key in want and m["kind"] == "counter":
                    got[key] = m["value"]
            return got

        while merged_actor_counters() != want:
            assert time.monotonic() < deadline, (merged_actor_counters(), want)
            time.sleep(0.05)
        with urllib.request.urlopen(server._exporter.url + "/fleet",
                                    timeout=5) as resp:
            doc = json.loads(resp.read().decode())
        tiers = {p["proc"]: p["tier"] for p in doc["procs"]}
        assert tiers == {"drill-w0": "actor", server._fleet_proc: "server"}
        assert not [a for a in doc["alerts"] if a["active"]]
        assert ag.snapshot_metric(doc["merged"],
                                  "relayrl_actor_env_steps_total") > 0
        pane = io.StringIO()
        with contextlib.redirect_stdout(pane):
            assert top.main(["--url", server._exporter.url, "--fleet",
                             "--once"]) == 0
        assert "2 proc(s)" in pane.getvalue()
        assert "-- actor " in pane.getvalue()
    finally:
        if worker is not None and worker.poll() is None:
            worker.kill()
            worker.communicate()
        server.disable_server()
