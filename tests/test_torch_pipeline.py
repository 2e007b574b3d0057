"""The port's learner pipeline and checkpoints.

* ``InflightWindow`` bounds dispatched-but-unfenced updates and drains.
* ``LazyMetrics`` resolves an update's metrics in one stacked
  device-to-host read, once, with no per-metric ``.item()``.
* A publish snapshot taken before an update still holds the pre-update
  params after it (the optimizer moves the live params in place).
* ``ModelPublisher`` coalesces latest-wins.
* The torch checkpoint round trip restores a learner whose next update is
  bit-identical to the uninterrupted learner's, and refuses a mismatched
  arch.

Everything runs on the CPU with the MLP family (16x16); every comparison
is exact.
"""

import threading

import numpy as np
import pytest
import torch

from relayrl_tpu_torch.algorithms import build_algorithm
from relayrl_tpu_torch.checkpoint import (
    CheckpointManager,
    StepAlreadyExistsError,
    checkpoint_algorithm,
    restore_algorithm,
)
from relayrl_tpu_torch.runtime.pipeline import (
    InflightWindow,
    LazyMetrics,
    ModelPublisher,
    PublishSnapshot,
)
from relayrl_tpu_torch.types.action import ActionRecord
from relayrl_tpu_torch.weights import params_to_jax, tree_digest

OBS, ACT = 4, 2


def _algo(tmp_path, **over):
    kw = dict(obs_dim=OBS, act_dim=ACT, hidden_sizes=[16, 16],
              with_vf_baseline=True, traj_per_epoch=2, train_vf_iters=3,
              seed_salt=0, env_dir=str(tmp_path), device="cpu")
    kw.update(over)
    return build_algorithm("REINFORCE", **kw)


def _episode(rng, n=6):
    recs = [ActionRecord(obs=rng.standard_normal(OBS).astype(np.float32),
                         act=np.array(int(rng.integers(ACT)), np.int32),
                         rew=float(rng.standard_normal()),
                         data={"logp_a": np.float32(-0.7),
                               "v": np.float32(rng.standard_normal())})
            for _ in range(n)]
    recs.append(ActionRecord(rew=1.0, done=True))
    return recs


def _batch(algo, rng):
    got = None
    while got is None:
        got = algo.accumulate(_episode(rng))
    return got


class _Event:
    def __init__(self):
        self.synced = 0

    def synchronize(self):
        self.synced += 1


def test_inflight_window_depth_and_drain():
    win = InflightWindow(max_in_flight=2)
    events = [_Event() for _ in range(5)]
    metrics = [LazyMetrics({"x": torch.tensor(float(i))}) for i in range(5)]
    for i in range(5):
        win.push(metrics[i], events[i])
        assert win.pending == min(i + 1, 2)
    assert (win.dispatch_count, win.fenced_count) == (5, 3)
    assert [e.synced for e in events] == [1, 1, 1, 0, 0]
    # A fence resolves the update's metrics (its one device-to-host read).
    assert metrics[0]._host == {"x": 0.0} and metrics[4]._host is None
    win.drain()
    assert (win.pending, win.fenced_count) == (0, 5)
    assert [e.synced for e in events] == [1] * 5
    sync = InflightWindow(max_in_flight=0)
    sync.push(None, None)
    assert (sync.pending, sync.fenced_count) == (0, 1)


def test_lazy_metrics_one_stacked_read(monkeypatch):
    values = {"LossPi": torch.tensor(0.5), "KL": torch.tensor(-1.25),
              "Count": torch.tensor(3)}
    reads = []
    real_tolist = torch.Tensor.tolist

    def tolist(self):
        reads.append(tuple(self.shape))
        return real_tolist(self)

    def no_item(self):
        raise AssertionError("per-metric .item()")

    monkeypatch.setattr(torch.Tensor, "tolist", tolist)
    monkeypatch.setattr(torch.Tensor, "item", no_item)
    lazy = LazyMetrics(values)
    assert repr(lazy).endswith("in-flight)")
    assert reads == []
    assert lazy["KL"] == -1.25
    assert dict(lazy) == {"LossPi": 0.5, "KL": -1.25, "Count": 3.0}
    assert lazy.resolve() is lazy.resolve()
    assert reads == [(3,)]  # one stacked read of all three
    assert len(lazy) == 3 and list(lazy) == ["LossPi", "KL", "Count"]


def test_snapshot_before_update_keeps_pre_update_params(tmp_path):
    algo = _algo(tmp_path)
    rng = np.random.default_rng(0)
    batch = _batch(algo, rng)
    before = params_to_jax(algo.state.params)
    snap = algo.snapshot_for_publish()
    assert isinstance(snap, PublishSnapshot) and snap.version == 0
    algo.train_on_batch(batch)
    after = params_to_jax(algo.state.params)
    assert tree_digest(after) != tree_digest(before)
    assert tree_digest(snap.host_params()) == tree_digest(before)
    assert algo.snapshot_for_publish().version == algo.version == 1
    assert tree_digest(algo.snapshot_for_publish().host_params()) == \
        tree_digest(after)
    # The update entered the in-flight window; the window fences it.
    assert algo.inflight.dispatch_count == 1
    algo.inflight.drain()
    assert algo.inflight.fenced_count == 1


def test_publisher_coalesces_latest_wins():
    gate = threading.Event()
    published = []

    def publish(snapshot):
        gate.wait(5)
        published.append(snapshot.version)

    pub = ModelPublisher(publish)
    try:
        for version in range(1, 5):
            pub.submit(PublishSnapshot(version, {}, {}))
        gate.set()
        assert pub.drain(timeout=5)
        assert published[0] in (1, 4) and published[-1] == 4
        assert pub.coalesced >= 2 and pub.pending == 0
    finally:
        pub.stop()


def test_checkpoint_roundtrip_next_update_bit_identical(tmp_path):
    rng = np.random.default_rng(3)
    first = _algo(tmp_path / "a")
    batches = [_batch(first, rng) for _ in range(3)]
    first.train_on_batch(batches[0])
    first.log_epoch()
    ckpt = str(tmp_path / "ckpt")
    mgr = checkpoint_algorithm(first, ckpt, extra_meta={"healthy": True})
    assert mgr.all_steps() == [1] and mgr.healthy_steps() == [1]
    assert mgr.read_extra(1)["epoch"] == 1
    with pytest.raises(StepAlreadyExistsError):
        checkpoint_algorithm(first, ckpt)
    metrics = [dict(first.train_on_batch(b)) for b in batches[1:]]

    resumed = _algo(tmp_path / "b", seed_salt=7)  # other initial params
    restore_algorithm(resumed, ckpt)
    assert (resumed.version, resumed.epoch) == (1, 1)
    got = [dict(resumed.train_on_batch(b)) for b in batches[1:]]
    assert got == metrics
    assert resumed.version == first.version == 3
    assert tree_digest(params_to_jax(resumed.state.params)) == \
        tree_digest(params_to_jax(first.state.params))
    for name in ("pi_opt", "vf_opt"):
        a = getattr(first.state, name).state_dict()["state"]
        b = getattr(resumed.state, name).state_dict()["state"]
        for key in a:
            for field in a[key]:
                assert torch.equal(a[key][field], b[key][field]), (name, field)


def test_checkpoint_retention_overwrite_and_arch_guard(tmp_path):
    algo = _algo(tmp_path / "a")
    rng = np.random.default_rng(1)
    ckpt = str(tmp_path / "ckpt")
    for _ in range(4):
        algo.train_on_batch(_batch(algo, rng))
        checkpoint_algorithm(algo, ckpt, max_to_keep=2)
    mgr = CheckpointManager(ckpt)
    assert mgr.all_steps() == [3, 4]
    checkpoint_algorithm(algo, ckpt, overwrite=True, max_to_keep=3)
    assert mgr.all_steps() == [3, 4, 5]  # bumped, never deleted
    assert mgr.read_extra(5)["version"] == 4
    other = _algo(tmp_path / "b", hidden_sizes=[8])
    with pytest.raises(ValueError, match="arch"):
        restore_algorithm(other, ckpt)
    with pytest.raises(FileNotFoundError):
        restore_algorithm(other, str(tmp_path / "empty"))
