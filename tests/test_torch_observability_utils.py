"""The port's small observability utilities against the JAX package's.

* ``utils.tb_writer.TensorboardWriter`` makes the same scalar calls from
  the same ``progress.txt`` (recorded through a stub writer), across a
  header change and appended rows.
* ``utils.plot``: the same progress tables, the same ``smooth_series``,
  and a figure written without a display.
* ``utils.instrument.instrument_agent`` counts bytes, sends and steps.
* ``utils.profiling``: ``trace`` writes a CPU Chrome trace holding the
  ``annotate``d range and the operators inside it; ``timed`` returns the
  result and a duration; the on-demand trace server captures, refuses a
  bad request and shuts down.
* ``utils.hostpin.pin_cpu`` hides the cards before CUDA starts and raises
  once it has (held by a stub: there is no CUDA here).
* ``relayrl_tpu_torch.utils`` exports the JAX package's names.
* The training server takes ``telemetry.trace_sample_rate``,
  ``telemetry.fleet_interval_s`` and ``tensorboard=True``, each of which
  it once refused.
"""

from __future__ import annotations

import json
import sys
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from relayrl_tpu import utils as jax_utils
from relayrl_tpu.utils import plot as jax_plot
from relayrl_tpu.utils import tb_writer as jax_tb
from relayrl_tpu_torch import utils
from relayrl_tpu_torch.utils import hostpin, plot, profiling, tb_writer
from relayrl_tpu_torch.utils.instrument import instrument_agent


def _progress(path, rows: int, seed: int, header=("Epoch", "AverageEpRet",
                                                    "LossPi", "LossV")):
    rng = np.random.default_rng(seed)
    fresh = not path.exists() or path.stat().st_size == 0
    with open(path, "a") as f:
        if fresh:
            f.write("\t".join(header) + "\n")
        for epoch in range(rows):
            vals = [str(epoch)] + [f"{v:.6g}" for v in
                                   rng.standard_normal(len(header) - 1)]
            f.write("\t".join(vals) + "\n")


class _StubWriter:
    def __init__(self):
        self.calls = []

    def add_scalar(self, tag, value, step):
        self.calls.append((tag, value, step))

    def flush(self):
        self.calls.append("flush")

    def close(self):
        self.calls.append("close")


def test_tensorboard_writer_calls_equal(tmp_path):
    calls = []
    for mod in (tb_writer, jax_tb):
        run = tmp_path / mod.__name__
        run.mkdir()
        progress = run / "progress.txt"
        writer = mod.TensorboardWriter(
            str(progress), scalar_tags="AverageEpRet;LossPi;Missing",
            logdir=str(run / "tb"))
        stub = writer._writer = _StubWriter()
        assert writer.poll() == 0  # no file yet
        _progress(progress, 3, seed=0)
        written = [writer.poll()]
        with open(progress, "a") as f:
            f.write("7\t1.5\tnot-a-number\t2\n")
            f.write("short\trow\n")
        written.append(writer.poll())
        progress.write_text("Epoch\tLossPi\n0\t0.25\n1\t0.5\n")
        written.append(writer.poll())
        writer.close()
        calls.append((written, stub.calls))
    assert calls[0] == calls[1]
    assert calls[0][0] == [3, 1, 2]


def test_plot_tables_and_smoothing_equal(tmp_path):
    for k in range(2):
        run = tmp_path / f"run{k}"
        run.mkdir()
        _progress(run / "progress.txt", 12, seed=k)
    files = plot.find_progress_files(str(tmp_path))
    assert files == jax_plot.find_progress_files(str(tmp_path))
    assert len(files) == 2
    for path in files:
        assert plot.load_dataset(path).equals(jax_plot.load_dataset(path))
    assert plot.get_newest_dataset(str(tmp_path)).equals(
        jax_plot.get_newest_dataset(str(tmp_path)))
    assert plot.get_newest_dataset(str(tmp_path / "run0" / "none")) is None
    values = np.random.default_rng(3).standard_normal(40)
    for radius in (0, 1, 5):
        np.testing.assert_array_equal(plot.smooth_series(values, radius),
                                      jax_plot.smooth_series(values, radius))
    out = tmp_path / "curve.png"
    fig = plot.plot_progress(str(tmp_path), value="LossPi", smooth=2,
                             out_path=str(out))
    assert out.stat().st_size > 0 and len(fig.axes[0].lines) == 2
    with pytest.raises(ValueError):
        plot.plot_progress(str(tmp_path), value="NoSuchColumn")


def test_instrument_agent_counts():
    sent = []
    agent = types.SimpleNamespace(
        transport=types.SimpleNamespace(
            send_trajectory=lambda raw, agent_id=None: sent.append(
                (agent_id, raw))),
        request_for_action=lambda obs, **kw: ("act", obs, kw))
    counters = instrument_agent(agent)
    for k in range(5):
        assert agent.request_for_action(k, reward=1.0) == (
            "act", k, {"reward": 1.0})
    agent.transport.send_trajectory(b"abc", agent_id="a#s1")
    agent.transport.send_trajectory(b"de")
    assert counters == {"bytes": 5, "sends": 2, "steps": 5}
    assert sent == [("a#s1", b"abc"), (None, b"de")]


def test_profiling_trace_holds_the_annotated_range(tmp_path):
    import torch

    x = torch.randn(32, 32)
    with profiling.trace(str(tmp_path / "prof")) as prof:
        with profiling.annotate("update_range"):
            y = (x @ x).relu().sum()
    assert prof.trace_path is not None
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    ranges = [e for e in events if e.get("name") == "update_range"
              and e.get("ph") == "X"]
    assert len(ranges) == 1
    r0, r1 = ranges[0]["ts"], ranges[0]["ts"] + ranges[0]["dur"]
    inside = [e["name"] for e in events if e.get("ph") == "X"
              and e.get("name", "").startswith("aten::")
              and r0 <= e["ts"] <= r1]
    assert "aten::mm" in inside or "aten::matmul" in inside
    out, seconds = profiling.timed(lambda a: {"y": a * 2, "n": 3}, y)
    assert out["n"] == 3 and torch.equal(out["y"], y * 2) and seconds >= 0


def test_trace_server_captures_on_demand(tmp_path):
    server = profiling.start_trace_server(port=0, log_dir=str(tmp_path / "p"))
    base = f"http://127.0.0.1:{server.port}"
    try:
        with urllib.request.urlopen(base + "/capture?seconds=0.2",
                                    timeout=30) as resp:
            doc = json.loads(resp.read().decode())
        assert doc["seconds"] == 0.2
        with open(doc["trace"]) as f:
            assert "traceEvents" in json.load(f)
        with urllib.request.urlopen(base + "/", timeout=5) as resp:
            assert json.loads(resp.read().decode())["captures"] == [
                doc["trace"]]
        for bad, code in (("/capture?seconds=0", 400),
                          ("/capture?seconds=x", 400), ("/nope", 404)):
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(base + bad, timeout=5)
            assert err.value.code == code
    finally:
        server.shutdown()


def test_pin_cpu_hides_cards_and_refuses_after_cuda(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    fake = types.SimpleNamespace(
        cuda=types.SimpleNamespace(is_initialized=lambda: True))
    monkeypatch.setitem(sys.modules, "torch", fake)
    with pytest.raises(RuntimeError, match="CUDA was initialised"):
        hostpin.pin_cpu()
    assert hostpin.os.environ["CUDA_VISIBLE_DEVICES"] == "0"
    fake.cuda.is_initialized = lambda: False
    hostpin.pin_cpu(virtual_devices=8)
    assert hostpin.os.environ["CUDA_VISIBLE_DEVICES"] == ""


def test_utils_exports_match():
    assert sorted(utils.__all__) == sorted(jax_utils.__all__)
    for name in utils.__all__:
        assert callable(getattr(utils, name))


@pytest.mark.parametrize("key", ["trace_sample_rate", "fleet_interval_s",
                                 "tensorboard"])
def test_server_takes_the_observability_keys(key, tmp_path):
    """The keys the server once refused: tracing installs the process
    tracer at the configured rate, the fleet plane builds the root's table
    and alert engine behind the exporter, and ``tensorboard=True`` tails
    each epoch's progress.txt row into TensorBoard scalars."""
    from relayrl_tpu_torch import telemetry
    from relayrl_tpu_torch.telemetry import trace
    from relayrl_tpu_torch.runtime.server import TrainingServer
    from relayrl_tpu_torch.types.action import ActionRecord

    telemetry.reset_for_tests()
    tel = {"enabled": True, "port": 0}
    if key != "tensorboard":
        tel[key] = 0.5
    path = tmp_path / "config.json"
    path.write_text(json.dumps({"guardrails": {"enabled": False},
                                "telemetry": tel}))
    server = TrainingServer(
        "REINFORCE", obs_dim=4, act_dim=2, env_dir=str(tmp_path),
        config_path=str(path), device="cpu", start=False,
        tensorboard=key == "tensorboard",
        hyperparams={"traj_per_epoch": 1, "hidden_sizes": [8],
                     "train_vf_iters": 1})
    try:
        if key == "trace_sample_rate":
            assert trace.get_tracer().enabled
            assert trace.get_tracer().sample_rate == 0.5
            assert server._fleet is None and server._tb is None
        elif key == "fleet_interval_s":
            assert trace.get_tracer() is trace.NULL_TRACER
            assert server._fleet is not None and server._alerts is not None
            with urllib.request.urlopen(server._exporter.url + "/fleet",
                                        timeout=5) as resp:
                assert json.loads(resp.read().decode())["schema"] == \
                    "relayrl-fleet-v1"
        else:
            stub = server._tb._writer = _StubWriter()
            obs = np.zeros(4, np.float32)
            records = [ActionRecord(obs=obs, act=np.asarray(0, np.int32),
                                    rew=1.0, data={"logp_a": np.float32(-0.7),
                                                   "v": np.float32(0.0)})
                       for _ in range(3)]
            records.append(ActionRecord(obs=None, rew=1.0, done=True))
            server.transport.publish_model = lambda *a, **k: None
            server._process_one(records)
            server._pipeline_quiesce()
            assert [c[:1] for c in stub.calls if c != "flush"] == [
                ("AverageEpRet",), ("LossPi",)]
            assert stub.calls[-1] == "flush"
    finally:
        server.disable_server()
        telemetry.reset_for_tests()  # closes the exporter too
