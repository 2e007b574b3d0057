"""The port's serving plane on the CPU.

* The wire: request (v1 and v2 session fields), wave, reply, reply-wave
  and nack frames are byte for byte the JAX package's, and a port
  client's starting key is ``jax.random.PRNGKey(seed)``'s words.
* The keyed batched steps: pure in each row's key, padding rows inert,
  a row's draw independent of its batchmates (at one bucket).
* The batching queue: size and deadline closes, bucket padding, the
  overload and stale nacks, one params version per batch under a racing
  swapper, ``install_params`` owning its memory.
* Sessions: served == local over episodes, the idempotent push retry, the
  out-of-step nack, LRU eviction with a bit-identical continuation after
  the resync, TTL expiry.
* Served == local, bit for bit: a ``RemoteActorClient`` and a
  ``MultiplexedRemoteClient`` against the keyed step driven locally at
  the bucket the service dispatched.
* Against the JAX package, by scoring: the JAX policy's ``evaluate`` of
  every served action, from the same params, gives the shipped
  ``logp_a`` and ``v`` within ``SCORE_ATOL`` (f32).
* The loop: a port ``TrainingServer(serving=True)`` serves and trains
  over ZMQ and over gRPC ``GetActions``; a standalone host follows the
  publishes; the JAX and port clients and services interoperate on the
  ZMQ wire.

Models: ``mlp_discrete`` 4 -> 2 and ``transformer_discrete`` at d_model
32, 2 layers, 2 heads, T 16 (flash attention: its plain version on the
CPU). Every wait is bounded at 30 s or less.
"""

import json
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from _util import free_port
from relayrl_tpu import faults as jax_faults
from relayrl_tpu import telemetry as jax_telemetry
from relayrl_tpu_torch import faults, telemetry

MLP_ARCH = {"kind": "mlp_discrete", "obs_dim": 4, "act_dim": 2,
            "hidden_sizes": [16, 16]}
TF_ARCH = {"kind": "transformer_discrete", "obs_dim": 4, "act_dim": 3,
           "d_model": 32, "n_layers": 2, "n_heads": 2, "max_seq_len": 16,
           "attention": "flash"}
# Served f32 logp_a / v against the JAX policy's evaluate of the same
# action from the same params (threefry and Philox cannot agree on the
# draw, so the action is scored, not redrawn).
SCORE_ATOL = 2e-5
WAIT_S = 30


@pytest.fixture(autouse=True)
def _clean_planes():
    from relayrl_tpu.transport.retry import (
        reset_metrics_for_tests as jax_reset_retry,
    )
    from relayrl_tpu_torch.transport.retry import reset_metrics_for_tests

    for mod in (faults, telemetry, jax_faults, jax_telemetry):
        mod.reset_for_tests()
    telemetry.set_registry(telemetry.Registry(run_id="serving-test"))
    reset_metrics_for_tests()
    jax_reset_retry()
    yield
    for mod in (faults, telemetry, jax_faults, jax_telemetry):
        mod.reset_for_tests()
    reset_metrics_for_tests()
    jax_reset_retry()


def _bundle(arch, version=1, seed=0):
    from relayrl_tpu_torch.models import build_policy
    from relayrl_tpu_torch.types import ModelBundle
    from relayrl_tpu_torch.weights import params_to_jax

    policy = build_policy(arch, "cpu")
    params = policy.init_params(torch.Generator().manual_seed(seed))
    return ModelBundle(version=version, arch=dict(arch),
                       params=params_to_jax(params))


def _versioned_bundle(bundle, version):
    """Params whose value head outputs exactly ``version`` for any obs, so
    ``aux['v']`` names the params that served each action."""
    import copy

    from relayrl_tpu_torch.types import ModelBundle

    params = copy.deepcopy(bundle.params)
    head = params["params"]["vf_head"]
    head["kernel"] = np.zeros_like(head["kernel"])
    head["bias"] = np.full_like(head["bias"], float(version))
    return ModelBundle(version=version, arch=dict(bundle.arch), params=params)


def _service(bundle, **kw):
    from relayrl_tpu_torch.runtime.inference import InferenceService

    kw.setdefault("max_batch", 1)
    kw.setdefault("batch_timeout_ms", 1.0)
    return InferenceService(bundle, device="cpu", **kw)


def _record_dispatches(svc) -> list:
    """Wraps ``svc``'s keyed step so every dispatch appends its padded
    keys (``len`` is the bucket) to the returned list."""
    name = "_window_fn" if svc._window_fn is not None else "_batched_fn"
    step, log = getattr(svc, name), []

    def recorded(params, keys, *rest):
        log.append(keys)
        return step(params, keys, *rest)

    setattr(svc, name, recorded)
    return log


def _submit(svc, key, obs, req_id=1, agent_id="t", mask=None,
            session=None, reset=False, window=None, step=0):
    """One decoded request against a live service: ``(event, box)``, the
    decoded reply in ``box['reply']`` once the event fires."""
    from relayrl_tpu_torch.transport.serving import (
        pack_infer_request,
        unpack_infer_reply,
    )

    box: dict = {}
    done = threading.Event()

    def reply(b):
        box["reply"] = unpack_infer_reply(b)
        done.set()

    svc.handle_request(
        pack_infer_request(agent_id, req_id, key, obs, mask,
                           session=session, reset=reset, window=window,
                           step=step), reply)
    return done, box


def _served(svc, *args, **kw):
    done, box = _submit(svc, *args, **kw)
    assert done.wait(WAIT_S), "no reply"
    return box["reply"]


class _Local:
    """The keyed step driven locally one request at a time (bucket 1), as
    a thin client's requests reach a ``max_batch`` 1 service: its own
    key, and for a sequence policy its own rolling window, reset at an
    episode boundary."""

    def __init__(self, bundle, seed):
        from relayrl_tpu_torch.models import build_policy
        from relayrl_tpu_torch.runtime.inference import prng_key
        from relayrl_tpu_torch.runtime.policy_actor import (
            make_keyed_batched_step,
            make_keyed_batched_window_step,
            resolve_actor_context,
        )
        from relayrl_tpu_torch.types.model_bundle import exploration_kwargs

        self.policy = build_policy(bundle.arch, "cpu")
        self.params = self.policy.load_params(bundle.params)
        self.key = prng_key(seed)
        self.explore = exploration_kwargs(bundle.arch)
        self.window = None
        if self.policy.step_window is not None:
            self.window = np.zeros((resolve_actor_context(bundle.arch),
                                    bundle.arch["obs_dim"]), np.float32)
            self.length = 0
            self.fn = make_keyed_batched_window_step(self.policy)
        else:
            self.fn = make_keyed_batched_step(self.policy)

    def act(self, obs, mask=None):
        from relayrl_tpu_torch.runtime.policy_actor import push_window

        masks = None if mask is None else np.asarray(mask, np.float32)[None]
        if self.window is not None:
            self.length, _ = push_window(self.window, self.length, obs)
            acts, aux, keys = self.fn(self.params, self.key[None],
                                      self.window[None],
                                      np.array([self.length], np.int32), masks)
        else:
            acts, aux, keys = self.fn(self.params, self.key[None],
                                      np.asarray(obs, np.float32)[None], masks,
                                      self.explore)
        self.key = keys[0]
        return np.asarray(acts[0]), {k: np.asarray(v[0]) for k, v in aux.items()}

    def end_episode(self):
        if self.window is not None:
            self.window[:] = 0.0
            self.length = 0


def _assert_served_equals(reply_or_record, act, aux):
    if isinstance(reply_or_record, dict):
        got_act, got_aux = reply_or_record["act"], reply_or_record["aux"]
    else:
        got_act, got_aux = reply_or_record.act, reply_or_record.data
    assert np.array_equal(got_act, act) and got_act.dtype == act.dtype
    assert got_act.shape == act.shape
    for k in aux:
        assert np.array_equal(got_aux[k], aux[k]), k
        assert got_aux[k].dtype == aux[k].dtype, k


# -- the wire ---------------------------------------------------------------

def _frames(pkg):
    """Every serving frame kind, packed by ``pkg``'s serving module."""
    import importlib

    s = importlib.import_module(f"{pkg}.transport.serving")
    rng = np.random.default_rng(0)
    key = np.array([0, 7], np.uint32)
    obs = rng.standard_normal(4).astype(np.float32)
    win = rng.standard_normal((3, 4)).astype(np.float32)
    mask = np.array([1.0, 0.0, 1.0], np.float32)
    aux = {"logp_a": np.asarray(np.float32(-0.5)),
           "v": np.asarray(np.float32(1.25))}
    entries = [{"id": f"a#L{i:03d}", "req": i + 1, "key": key + i,
                "obs": obs + i, "mask": None, "sid": f"a#L{i:03d}",
                "stp": i + 2, "rst": i == 0} for i in range(3)]
    acts = np.arange(3, dtype=np.int32)
    return {
        "request_v1": s.pack_infer_request("a", 3, key, obs, mask),
        "request_v2": s.pack_infer_request(
            "a", 4, key, np.arange(8, dtype=np.uint8), None, session="a",
            reset=True, window=win, step=5),
        "wave": s.pack_infer_wave(entries),
        "reply": s.pack_action_reply(4, 9, np.asarray(np.int32(2)),
                                     key + 1, aux, ctx=16),
        "reply_wave": s.pack_reply_wave(
            [1, 2, 3], 9, acts, np.stack([key] * 3),
            {k: np.stack([v] * 3) for k, v in aux.items()}, ctx=16),
        "nack": s.pack_infer_nack(5, 3, "inference queue full", 0.05),
    }


@pytest.mark.parametrize("kind", ["request_v1", "request_v2", "wave", "reply",
                                  "reply_wave", "nack"])
def test_frames_equal_reference(kind):
    """Each frame's bytes equal the JAX package's, and each package
    decodes the other's frame into the same fields."""
    from relayrl_tpu.transport import serving as jax_serving
    from relayrl_tpu_torch.transport import serving

    ours, theirs = _frames("relayrl_tpu_torch")[kind], _frames("relayrl_tpu")[kind]
    assert ours == theirs
    unpack = ("unpack_infer_any" if kind.startswith(("request", "wave"))
              else "unpack_reply_any")
    a = getattr(serving, unpack)(theirs)
    b = getattr(jax_serving, unpack)(ours)
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra.keys() == rb.keys()
        for k in ra:
            va, vb = ra[k], rb[k]
            if isinstance(va, dict):
                assert va.keys() == vb.keys()
                for name in va:
                    assert np.array_equal(va[name], vb[name])
                    assert va[name].dtype == vb[name].dtype
            elif isinstance(va, np.ndarray):
                assert np.array_equal(va, vb) and va.dtype == vb.dtype
            else:
                assert va == vb, k


@pytest.mark.parametrize("seed", [0, 7, 4242, 2**31 + 5])
def test_prng_key_is_jax_prng_key(seed):
    from relayrl_tpu_torch.runtime.inference import prng_key

    assert np.array_equal(prng_key(seed), np.asarray(jax.random.PRNGKey(seed)))


# -- the keyed steps ----------------------------------------------------------

KEYED_ARCHS = {"mlp": MLP_ARCH,
               "mlp_continuous": {**MLP_ARCH, "kind": "mlp_continuous"},
               "transformer": TF_ARCH}


@pytest.mark.parametrize("name", sorted(KEYED_ARCHS))
def test_keyed_step_pure_padding_inert_batch_independent(name):
    from relayrl_tpu_torch.models import build_policy
    from relayrl_tpu_torch.runtime.policy_actor import (
        make_keyed_batched_step,
        make_keyed_batched_window_step,
    )

    arch = KEYED_ARCHS[name]
    policy = build_policy(arch, "cpu")
    params = policy.init_params(torch.Generator().manual_seed(1))
    rng = np.random.default_rng(3)
    keys = np.array([[0, s] for s in (5, 6, 7, 8)], np.uint32)
    if policy.step_window is not None:
        fn = make_keyed_batched_window_step(policy)
        inputs = rng.standard_normal((4, 16, 4)).astype(np.float32)
        ts = np.array([1, 9, 16, 4], np.int32)

        def run(k, x):
            return fn(params, k, x, ts, None)
    else:
        fn = make_keyed_batched_step(policy)
        inputs = rng.standard_normal((4, 4)).astype(np.float32)

        def run(k, x):
            return fn(params, k, x, None, {})

    acts, aux, nxt = run(keys, inputs)
    # Pure: the same keys recompute bit for bit.
    acts2, aux2, nxt2 = run(keys, inputs)
    assert np.array_equal(acts, acts2) and np.array_equal(nxt, nxt2)
    for k in aux:
        assert np.array_equal(aux[k], aux2[k])
    # The successor key is a function of the row's key alone.
    assert nxt.dtype == np.uint32 and nxt.shape == (4, 2)
    assert np.array_equal(run(keys[[3, 2, 1, 0]], inputs)[2], nxt[[3, 2, 1, 0]])
    assert len({tuple(r) for r in nxt}) == 4
    # Padding inert: the last row replaced by other content and key.
    pad_keys = keys.copy()
    pad_keys[3] = [9, 9]
    pad_inputs = inputs.copy()
    pad_inputs[3] = rng.standard_normal(pad_inputs[3].shape)
    p_acts, p_aux, p_nxt = run(pad_keys, pad_inputs)
    assert np.array_equal(p_acts[:3], acts[:3]) and np.array_equal(p_nxt[:3], nxt[:3])
    for k in aux:
        assert np.array_equal(p_aux[k][:3], aux[k][:3])
    # Batch independent: new content and keys in every other row leave a
    # row as it was (at its position; a row moved to another position of
    # the batch may round differently through the forward).
    for i in (0, 2):
        o_keys = np.where(np.arange(4)[:, None] == i, keys, keys + 100).astype(np.uint32)
        o_inputs = np.where((np.arange(4) == i).reshape((4,) + (1,) * (inputs.ndim - 1)),
                            inputs, rng.standard_normal(inputs.shape).astype(np.float32))
        o_acts, o_aux, o_nxt = run(o_keys, o_inputs)
        assert np.array_equal(o_acts[i], acts[i]) and np.array_equal(o_nxt[i], nxt[i])
        for k in aux:
            assert np.array_equal(o_aux[k][i], aux[k][i])


def test_keyed_draws_are_philox_of_the_row_key():
    """A row's noise is numpy Philox keyed by its two words (successor
    first): the same bits wherever the block lands."""
    from relayrl_tpu_torch.models.mlp import KeyedDraws

    keys = np.array([[1, 2], [3, 4]], np.uint32)
    draws = KeyedDraws(keys, "cpu")
    u = draws.uniform((2, 5)).numpy()
    g = np.random.Generator(np.random.Philox(key=(3 << 32) | 4))
    assert np.array_equal(draws.next_keys[1],
                          g.integers(0, 1 << 32, size=2, dtype=np.uint32))
    assert np.array_equal(u[1], g.random(5, dtype=np.float32))
    assert u.dtype == np.float32 and (u >= 0).all() and (u < 1).all()
    with pytest.raises(ValueError, match="keyed rows"):
        KeyedDraws(keys, "cpu").uniform((3, 5))


# -- the batching queue -------------------------------------------------------

def test_size_trigger_close():
    svc = _service(_bundle(MLP_ARCH), max_batch=4, batch_timeout_ms=5000.0)
    dispatched = _record_dispatches(svc)
    svc.start()
    try:
        obs = np.random.default_rng(0).standard_normal((4, 4)).astype(np.float32)
        t0 = time.monotonic()
        waits = [_submit(svc, np.array([0, i], np.uint32), obs[i], req_id=i + 1)
                 for i in range(4)]
        for done, box in waits:
            assert done.wait(WAIT_S) and box["reply"]["code"] == 1
        assert time.monotonic() - t0 < 2.0, "size close waited toward the deadline"
        assert svc._m_batches["size"].total() == 1
        assert svc._m_batches["deadline"].total() == 0
        assert len(dispatched) == 1
    finally:
        svc.stop()


def test_deadline_trigger_close():
    svc = _service(_bundle(MLP_ARCH), max_batch=64, batch_timeout_ms=40.0)
    svc.start()
    try:
        t0 = time.monotonic()
        reply = _served(svc, np.array([0, 1], np.uint32), np.zeros(4, np.float32))
        dt = time.monotonic() - t0
        assert reply["code"] == 1
        assert dt >= 0.030, f"closed before the deadline ({dt:.3f}s)"
        assert svc._m_batches["deadline"].total() == 1
    finally:
        svc.stop()


def test_bucket_padding_served_equals_keyed_step():
    """3 requests dispatch at bucket 4 (the last row repeated), and each
    reply equals the keyed step at bucket 4 on the same rows, and the
    real rows of an unpadded bucket-4 call with other content in row 4."""
    from relayrl_tpu_torch.runtime.policy_actor import make_keyed_batched_step

    bundle = _bundle(MLP_ARCH)
    svc = _service(bundle, max_batch=8, batch_timeout_ms=5000.0, buckets=[1, 2, 4, 8])
    dispatched = _record_dispatches(svc)
    keys = np.array([[0, 30 + i] for i in range(3)], np.uint32)
    obs = np.random.default_rng(1).standard_normal((3, 4)).astype(np.float32)
    waits = [_submit(svc, keys[i], obs[i], req_id=i + 1) for i in range(3)]
    svc.batch_timeout_s = 0.05
    svc.start()
    try:
        replies = []
        for done, box in waits:
            assert done.wait(WAIT_S)
            replies.append(box["reply"])
        (dispatch_keys,) = dispatched
        assert len(dispatch_keys) == 4
        fn = make_keyed_batched_step(svc.policy)
        pad_keys = np.concatenate([keys, [[0, 99]]]).astype(np.uint32)
        pad_obs = np.concatenate([obs, np.ones((1, 4), np.float32)])
        for k_in, o_in in ((np.concatenate([keys, keys[-1:]]),
                            np.concatenate([obs, obs[-1:]])), (pad_keys, pad_obs)):
            acts, aux, nxt = fn(svc.params, k_in, o_in, None, {})
            for i, reply in enumerate(replies):
                assert reply["code"] == 1
                _assert_served_equals(reply, np.asarray(acts[i]),
                                      {k: np.asarray(v[i]) for k, v in aux.items()})
                assert reply["key"] == nxt[i].tobytes()
    finally:
        svc.stop()


def test_queue_limit_overload_nack():
    from relayrl_tpu_torch.transport.base import NACK_OVERLOADED

    svc = _service(_bundle(MLP_ARCH), max_batch=4, batch_timeout_ms=5.0,
                   queue_limit=2, retry_after_s=0.25)
    key, obs = np.array([0, 0], np.uint32), np.zeros(4, np.float32)
    waits = [_submit(svc, key, obs, req_id=i + 1) for i in range(3)]
    done, box = waits[2]
    assert done.wait(5), "overload nack never delivered"
    assert box["reply"]["code"] == NACK_OVERLOADED
    assert box["reply"]["retry_after_s"] == pytest.approx(0.25)
    assert svc._m_rejected.total() == 1
    assert not waits[0][0].is_set() and not waits[1][0].is_set()
    # stop() answers the parked requests with a retryable nack too.
    svc.stop()
    for done_i, box_i in waits[:2]:
        assert done_i.wait(5)
        assert box_i["reply"]["code"] == NACK_OVERLOADED


def test_stale_requests_nacked_unserved():
    from relayrl_tpu_torch.transport.base import NACK_OVERLOADED

    svc = _service(_bundle(MLP_ARCH), max_batch=4, batch_timeout_ms=5.0,
                   stale_after_s=0.2)
    key, obs = np.array([0, 0], np.uint32), np.zeros(4, np.float32)
    dispatched = _record_dispatches(svc)
    waits = [_submit(svc, key, obs, req_id=i + 1) for i in range(2)]
    time.sleep(0.4)
    svc.start()
    try:
        for done, box in waits:
            assert done.wait(WAIT_S), "stale request never answered"
            assert box["reply"]["code"] == NACK_OVERLOADED
            assert "stale" in box["reply"]["error"]
        assert svc._m_stale.total() == 2 and not dispatched
        assert _served(svc, key, obs, req_id=9)["code"] == 1
    finally:
        svc.stop()


def test_single_params_version_per_batch_under_racing_swapper():
    base = _bundle(MLP_ARCH)
    svc = _service(_versioned_bundle(base, 1), max_batch=4, batch_timeout_ms=2.0)
    svc.start()
    stop = threading.Event()
    next_version = [2]

    def swapper():
        while not stop.is_set():
            svc.maybe_swap(_versioned_bundle(base, next_version[0]))
            next_version[0] += 1

    t = threading.Thread(target=swapper, daemon=True)
    t.start()
    try:
        key = np.array([0, 5], np.uint32)
        obs = np.random.default_rng(2).standard_normal(4).astype(np.float32)
        mismatches = []
        for i in range(30):
            reply = _served(svc, key, obs, req_id=i + 1)
            assert reply["code"] == 1
            if float(reply["aux"]["v"]) != float(reply["ver"]):
                mismatches.append((reply["ver"], float(reply["aux"]["v"])))
            key = np.frombuffer(reply["key"], np.uint32)
        assert not mismatches, mismatches[:3]
        assert svc.version >= 2
    finally:
        stop.set()
        t.join(timeout=5)
        svc.stop()


def test_install_params_owns_memory():
    """The colocated feed builds a new params module: mutating the
    publisher's host tree after the install changes nothing served, and
    the module a dispatch read earlier is left as it was."""
    base = _bundle(MLP_ARCH)
    svc = _service(_versioned_bundle(base, 1))
    svc.start()
    try:
        before = svc.params
        host_tree = _versioned_bundle(base, 2).params
        assert svc.install_params(2, base.arch, host_tree)
        assert svc.params is not before
        assert float(before.vf_head.bias.detach()[0]) == 1.0
        host_tree["params"]["vf_head"]["bias"][:] = 777.0
        reply = _served(svc, np.array([0, 0], np.uint32), np.zeros(4, np.float32))
        assert float(reply["aux"]["v"]) == 2.0 and reply["ver"] == 2
        assert not svc.install_params(2, base.arch, host_tree)  # not newer
    finally:
        svc.stop()


def test_malformed_and_sessionless_requests_get_errors():
    svc = _service(_bundle(TF_ARCH))
    svc.start()
    try:
        box = {}
        done = threading.Event()

        def reply(b):
            from relayrl_tpu_torch.transport.serving import unpack_infer_reply

            box["reply"] = unpack_infer_reply(b)
            done.set()

        svc.handle_request(b"\x00garbage", reply)
        assert done.wait(WAIT_S) and box["reply"]["code"] == 0
        assert box["reply"]["req"] == -1
        reply = _served(svc, np.array([0, 0], np.uint32), np.zeros(4, np.float32))
        assert reply["code"] == 0 and "serving.max_sessions" in reply["error"]
        assert svc._m_errors.total() == 2
    finally:
        svc.stop()


# -- sessions -----------------------------------------------------------------

class _SessionClient:
    """The session protocol a ``RemoteActorClient`` speaks, laid bare so a
    test can replay, evict and desync at will."""

    def __init__(self, svc, sid, seed):
        from relayrl_tpu_torch.runtime.inference import prng_key

        self.svc, self.sid = svc, sid
        self.key = prng_key(seed)
        self.step = 0
        self.episode_start = True
        self.mirror: list = []
        self._req = 0

    def raw(self, obs, with_win=False, step=None, key=None):
        self._req += 1
        win = np.stack(self.mirror) if (with_win and self.mirror) else None
        return _served(self.svc, self.key if key is None else key, obs,
                       req_id=self._req, agent_id=self.sid, session=self.sid,
                       reset=self.episode_start, window=win,
                       step=self.step + 1 if step is None else step)

    def act(self, obs):
        from relayrl_tpu_torch.transport.base import NACK_SESSION_EVICTED

        reply = self.raw(obs)
        if reply["code"] == NACK_SESSION_EVICTED:
            reply = self.raw(obs, with_win=True)
        assert reply["code"] == 1, reply.get("error")
        self.key = np.frombuffer(reply["key"], np.uint32).copy()
        self.step += 1
        self.episode_start = False
        self.mirror.append(np.asarray(obs, np.float32))
        del self.mirror[:max(0, len(self.mirror) - reply["ctx"])]
        return reply

    def end_episode(self):
        self.episode_start = True
        self.mirror = []


def test_session_served_equals_local_across_episodes():
    """Episodes longer than the window, so it rolls: served == the keyed
    window step driven locally, and the window zeroes at the boundary."""
    bundle = _bundle(TF_ARCH)
    svc = _service(bundle)
    svc.start()
    try:
        local, drv = _Local(bundle, seed=7), _SessionClient(svc, "par", seed=7)
        rng = np.random.default_rng(2)
        for length in (20, 5):
            for _ in range(length):
                obs = rng.standard_normal(4).astype(np.float32)
                act, aux = local.act(obs)
                _assert_served_equals(drv.act(obs), act, aux)
                assert np.array_equal(drv.key, local.key)
            local.end_episode()
            drv.end_episode()
        assert svc.accounting()["ctx"] == 16
    finally:
        svc.stop()


def test_idempotent_push_retry():
    bundle = _bundle(TF_ARCH)
    svc = _service(bundle)
    svc.start()
    try:
        local, drv = _Local(bundle, seed=3), _SessionClient(svc, "retry", seed=3)
        rng = np.random.default_rng(5)
        obs = rng.standard_normal(4).astype(np.float32)
        pre_key, pre_reset = drv.key.copy(), drv.episode_start
        first = drv.act(obs)
        # The reply was lost: the same cursor, key and reset flag again.
        drv.episode_start = pre_reset
        replay = drv.raw(obs, step=drv.step, key=pre_key)
        drv.episode_start = False
        assert replay["code"] == 1 and replay["key"] == first["key"]
        assert np.array_equal(first["act"], replay["act"])
        local.act(obs)
        obs2 = rng.standard_normal(4).astype(np.float32)
        act, aux = local.act(obs2)
        _assert_served_equals(drv.act(obs2), act, aux)
    finally:
        svc.stop()


def test_out_of_step_cursor_nacks():
    from relayrl_tpu_torch.transport.base import NACK_SESSION_EVICTED

    svc = _service(_bundle(TF_ARCH))
    svc.start()
    try:
        drv = _SessionClient(svc, "skew", seed=1)
        drv.act(np.zeros(4, np.float32))
        reply = drv.raw(np.ones(4, np.float32), step=drv.step + 5)
        assert reply["code"] == NACK_SESSION_EVICTED
        assert svc._m_session_nacked.total() == 1
    finally:
        svc.stop()


def test_lru_eviction_resync_bit_identical_continuation():
    from relayrl_tpu_torch.transport.base import NACK_SESSION_EVICTED

    bundle = _bundle(TF_ARCH)
    svc = _service(bundle, max_sessions=2)
    svc.start()
    try:
        local = _Local(bundle, seed=11)
        victim = _SessionClient(svc, "victim", seed=11)
        rng = np.random.default_rng(8)
        seq = [rng.standard_normal(4).astype(np.float32) for _ in range(6)]
        for obs in seq[:3]:
            act, aux = local.act(obs)
            _assert_served_equals(victim.act(obs), act, aux)
        for name in ("fresh-a", "fresh-b"):
            _SessionClient(svc, name, seed=1).act(np.zeros(4, np.float32))
        assert svc._m_evictions["lru"].total() >= 1
        assert victim.raw(seq[3])["code"] == NACK_SESSION_EVICTED
        for obs in seq[3:]:
            act, aux = local.act(obs)
            _assert_served_equals(victim.act(obs), act, aux)
        assert svc._m_resyncs.total() >= 1
        assert svc.accounting()["sessions"] <= 2
    finally:
        svc.stop()


def test_ttl_expiry_reaps_idle_sessions():
    svc = _service(_bundle(TF_ARCH), session_ttl_s=0.05)
    svc.start()
    try:
        _SessionClient(svc, "idle", seed=2).act(np.zeros(4, np.float32))
        time.sleep(0.15)
        _SessionClient(svc, "busy", seed=4).act(np.ones(4, np.float32))
        assert svc._m_evictions["ttl"].total() >= 1
        assert "idle" not in svc._sessions and "busy" in svc._sessions
    finally:
        svc.stop()


# -- against the JAX package, by scoring ---------------------------------------

@pytest.mark.parametrize("arch", [MLP_ARCH, TF_ARCH], ids=["mlp", "transformer"])
def test_served_actions_scored_by_jax_policy(arch):
    """The JAX policy, built from the same params (the port's weights
    function carries them across), scores every served action: its
    ``evaluate`` gives the shipped ``logp_a`` and ``v`` within
    ``SCORE_ATOL``."""
    from relayrl_tpu.models import build_policy as jax_build_policy

    bundle = _bundle(arch)
    svc = _service(bundle)
    svc.start()
    try:
        evaluate = jax.jit(jax_build_policy(bundle.arch).evaluate)
        params = jax.tree_util.tree_map(np.asarray, bundle.params)
        rng = np.random.default_rng(4)
        seq = arch is TF_ARCH
        drv = _SessionClient(svc, "score", seed=9)
        history, worst = [], 0.0
        for i in range(20):
            obs = rng.standard_normal(4).astype(np.float32)
            history.append(obs)
            if seq:
                reply = drv.act(obs)
                # The served window, zero-padded to 16 rows as the
                # service holds it (causal: the padding is never seen).
                window = np.zeros((16, 4), np.float32)
                rows = np.stack(history[-16:])
                window[:len(rows)] = rows
                logp, _, v = evaluate(params, window, np.full(16, reply["act"]))
                logp, v = np.asarray(logp)[len(rows) - 1], np.asarray(v)[len(rows) - 1]
            else:
                reply = _served(svc, drv.key, obs, req_id=i + 1)
                drv.key = np.frombuffer(reply["key"], np.uint32).copy()
                logp, _, v = evaluate(params, obs[None], reply["act"][None])
                logp, v = np.asarray(logp)[0], np.asarray(v)[0]
            assert reply["code"] == 1
            worst = max(worst, abs(float(logp) - float(reply["aux"]["logp_a"])),
                        abs(float(v) - float(reply["aux"]["v"])))
        assert worst <= SCORE_ATOL, worst
    finally:
        svc.stop()


# -- thin clients against a live service ---------------------------------------

class _FakeServingClient:
    """Scripted reply stream for the thin client's retry loop."""

    def __init__(self, script):
        self.script = list(script)
        self.calls = 0

    def request(self, payload, req_id, timeout_s):
        self.calls += 1
        step = self.script.pop(0)
        if isinstance(step, Exception):
            raise step
        return {"req": req_id, **step}

    def close(self):
        pass


def _bare_client(fake, infer_deadline_s=5.0):
    """A ``RemoteActorClient`` wired straight to a fake serving channel:
    the retry, breaker and nack loop, no sockets."""
    from relayrl_tpu_torch.runtime.inference import RemoteActorClient, prng_key
    from relayrl_tpu_torch.transport.retry import CircuitBreaker, RetryPolicy

    client = object.__new__(RemoteActorClient)
    client._serving = fake
    client._breaker = CircuitBreaker("test", failure_threshold=3, reset_timeout_s=0.2)
    client._retry = RetryPolicy(base_delay_s=0.01, max_delay_s=0.05)
    client._fault_infer = None
    client._rng = prng_key(0)
    client._req_counter = 0
    client._request_timeout_s = 0.2
    client._infer_deadline_s = infer_deadline_s
    client.version = -1
    client._session_id = "bare"
    client._session_step = 0
    client._episode_start = True
    client._mirror = []
    client._replica_addrs = None
    client._replica_idx = 0
    client._replica_fail_streak = 0
    client._serving_overrides = {}

    class _T:
        identity = "bare"

    client.transport = _T()
    reg = telemetry.get_registry()
    client._m_request_s = reg.histogram("relayrl_serving_client_request_seconds", "t")
    for name in ("retries", "nacked", "resyncs", "reroutes"):
        setattr(client, f"_m_{name}",
                reg.counter(f"relayrl_serving_client_{name}_total", "t"))
    return client


def _ok_reply(ver=3):
    return {"code": 1, "ver": ver, "act": np.asarray(np.int32(1)),
            "key": np.array([9, 9], np.uint32).tobytes(),
            "aux": {"v": np.asarray(np.float32(0.5))}}


@pytest.mark.parametrize("case", ["overload", "timeouts", "error", "deadline",
                                  "unavailable"])
def test_client_retry_loop(case):
    from relayrl_tpu_torch.transport.base import NACK_OVERLOADED, NACK_UNAVAILABLE

    obs = np.zeros(4, np.float32)
    if case == "overload":
        fake = _FakeServingClient([{"code": NACK_OVERLOADED, "error": "full",
                                    "retry_after_s": 0.15}, _ok_reply()])
        client = _bare_client(fake)
        t0 = time.monotonic()
        act, _ = client._infer(obs, None)
        assert time.monotonic() - t0 >= 0.14, "retry-after not honored"
        assert client._breaker.state == "closed"
        assert client._m_nacked.total() == 1 and client._m_retries.total() == 0
    elif case == "timeouts":
        fake = _FakeServingClient([TimeoutError("t")] * 3 + [_ok_reply(ver=7)])
        client = _bare_client(fake)
        act, _ = client._infer(obs, None)
        assert client.version == 7 and client._m_retries.total() == 3
        assert client._breaker.state == "closed"
    elif case == "error":
        fake = _FakeServingClient([{"code": 0, "error": "malformed"}, _ok_reply(ver=4)])
        client = _bare_client(fake)
        act, _ = client._infer(obs, None)
        assert client.version == 4 and fake.calls == 2
    elif case == "deadline":
        client = _bare_client(_FakeServingClient([TimeoutError("dead")] * 200),
                              infer_deadline_s=0.6)
        with pytest.raises(RuntimeError, match="budget"):
            client._infer(obs, None)
        return
    else:
        client = _bare_client(_FakeServingClient(
            [{"code": NACK_UNAVAILABLE, "error": "serving is not enabled"}]))
        with pytest.raises(RuntimeError, match="serving is not enabled"):
            client._infer(obs, None)
        return
    assert int(act) == 1
    assert np.array_equal(client._rng, np.array([9, 9], np.uint32))


def _stack_config(tmp, **serving) -> str:
    path = os.path.join(str(tmp), "serving_cfg.json")
    with open(path, "w") as f:
        json.dump({"guardrails": {"enabled": False},
                   "transport": {"small_model_bytes": 0},
                   "serving": {"enabled": True, "max_batch": 1,
                               "batch_timeout_ms": 1.0, "request_timeout_s": 5.0,
                               "infer_deadline_s": 20.0, **serving}}, f)
    return path


def _zmq_stack():
    addrs = {k: f"tcp://127.0.0.1:{free_port()}" for k in (
        "agent_listener_addr", "trajectory_addr", "model_pub_addr", "serving_addr")}
    client = {"agent_listener_addr": addrs["agent_listener_addr"],
              "trajectory_addr": addrs["trajectory_addr"],
              "model_sub_addr": addrs["model_pub_addr"],
              "serving_addr": addrs["serving_addr"], "probe": False}
    return addrs, client


HP = {"traj_per_epoch": 2, "hidden_sizes": [16, 16], "train_vf_iters": 3,
      "with_vf_baseline": True, "bucket_lengths": [16], "seed_salt": 0}


@pytest.mark.parametrize("server_type", ["zmq", "grpc"])
def test_server_serves_and_trains(tmp_cwd, server_type):
    """A port ``TrainingServer(serving=True)`` on the CPU: a thin client's
    first episode, at the pinned initial version, equals the keyed step
    driven locally bit for bit (and its shipped episode bytes equal the
    same records' trajectory); then three clients' episodes train, and
    the clients' ``model_version`` advances with the publishes."""
    from relayrl_tpu_torch.runtime.inference import RemoteActorClient
    from relayrl_tpu_torch.runtime.server import TrainingServer
    from relayrl_tpu_torch.types import ModelBundle
    from relayrl_tpu_torch.types.trajectory import Trajectory

    cfg = _stack_config(tmp_cwd)
    if server_type == "grpc":
        bind = f"127.0.0.1:{free_port()}"
        server_addrs = {"bind_addr": bind, "native_grpc": False}
        client_addrs = {"server_addr": bind, "probe": False}
    else:
        server_addrs, client_addrs = _zmq_stack()
    server = TrainingServer("REINFORCE", obs_dim=4, act_dim=2, env_dir=str(tmp_cwd),
                            config_path=cfg, server_type=server_type,
                            hyperparams=HP, device="cpu", **server_addrs)
    clients = []
    try:
        assert server.inference is not None
        if server_type == "grpc":
            assert server.transport.on_infer is not None
        b = server.algorithm.bundle()
        local = _Local(ModelBundle(version=b.version, arch=b.arch, params=b.params), 23)
        sent, local_sent = [], []
        client = RemoteActorClient(config_path=cfg, server_type=server_type, seed=23,
                                   identity="thin-23", **client_addrs)
        clients.append(client)
        client.trajectory._on_send = sent.append
        local_traj = Trajectory(max_length=client.config.get_max_traj_length(),
                                on_send=local_sent.append)
        rng = np.random.default_rng(11)
        for i in range(10):
            obs = rng.standard_normal(4).astype(np.float32)
            rec = client.request_for_action(obs, reward=0.0 if i == 0 else 0.5)
            act, aux = local.act(obs)
            _assert_served_equals(rec, act, aux)
            from relayrl_tpu_torch.types import ActionRecord

            if i:
                local_traj.get_actions()[-1].update_reward(0.5)
            local_traj.add_action(ActionRecord(obs=obs, act=act, data=aux, rew=0.0,
                                               done=False), send_if_done=True)
        client.flag_last_action(1.0, terminated=True)
        local_traj.add_action(ActionRecord(obs=None, rew=1.0, done=True),
                              send_if_done=True)
        assert sent == local_sent and len(sent) == 1
        client.trajectory._on_send = client._send_traj
        assert client.model_version == server.algorithm.version
        v0 = client.model_version

        clients += [RemoteActorClient(config_path=cfg, server_type=server_type,
                                      seed=s, identity=f"thin-{s}", **client_addrs)
                    for s in (1, 2)]
        stop = threading.Event()

        def drive(c, seed):
            r = np.random.default_rng(seed)
            while not stop.is_set():
                for _ in range(6):
                    c.request_for_action(r.standard_normal(4).astype(np.float32),
                                         reward=1.0)
                c.flag_last_action(1.0, terminated=True)

        threads = [threading.Thread(target=drive, args=(c, i), daemon=True)
                   for i, c in enumerate(clients)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline and (
                server.stats["updates"] < 2
                or min(c.model_version for c in clients) < v0 + 2):
            time.sleep(0.05)
        stop.set()
        for t in threads:
            t.join(timeout=WAIT_S)
        assert server.stats["updates"] >= 2, "thin-client episodes never trained"
        assert min(c.model_version for c in clients) >= v0 + 2, \
            "the colocated service never served the published versions"
        # The clients' last episodes may still be in flight, so an update
        # can finish just before its publish installs: wait until the
        # server is drained and the service holds the learner's version.
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline and not (
                server.drain(timeout=1.0)
                and server.inference.version == server.algorithm.version):
            time.sleep(0.05)
        assert server.inference.version == server.algorithm.version
        assert server.stats["learner_errors"] == 0
    finally:
        for c in clients:
            c.disable_agent()
        server.disable_server()


def test_grpc_server_without_serving_fails_fast(tmp_cwd):
    from relayrl_tpu_torch.runtime.inference import RemoteActorClient
    from relayrl_tpu_torch.runtime.server import TrainingServer

    bind = f"127.0.0.1:{free_port()}"
    cfg = _stack_config(tmp_cwd, enabled=False)
    server = TrainingServer("REINFORCE", obs_dim=4, act_dim=2, env_dir=str(tmp_cwd),
                            config_path=cfg, server_type="grpc", native_grpc=False,
                            bind_addr=bind, hyperparams=HP, device="cpu")
    try:
        assert server.inference is None
        client = RemoteActorClient(config_path=cfg, server_type="grpc", seed=1,
                                   probe=False, server_addr=bind)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="serving is not enabled"):
            client.request_for_action(np.zeros(4, np.float32))
        assert time.monotonic() - t0 < 10
        client.disable_agent()
    finally:
        server.disable_server()


def test_multiplexed_and_streamed_equal_local(tmp_cwd):
    """A ``MultiplexedRemoteClient`` of 4 transformer lanes over the ZMQ
    stream: every wave closes one bucket-4 batch, and each lane's action
    equals the keyed window step on the 4 lanes' windows at bucket 4;
    episode bytes ship per lane; and streamed out-of-order replies equal
    the lock-step client's for the same payloads."""
    from relayrl_tpu_torch.models import build_policy
    from relayrl_tpu_torch.runtime.inference import MultiplexedRemoteClient, prng_key
    from relayrl_tpu_torch.runtime.policy_actor import (
        make_keyed_batched_window_step,
        push_window,
    )
    from relayrl_tpu_torch.transport.serving import (
        ZmqServingClient,
        ZmqStreamingClient,
        pack_infer_request,
    )

    lanes = 4
    bundle = _bundle(TF_ARCH)
    svc = _service(bundle, max_batch=lanes, batch_timeout_ms=5000.0, buckets=[lanes])
    dispatched = _record_dispatches(svc)
    addr = f"tcp://127.0.0.1:{free_port()}"
    svc.bind_zmq(addr)
    svc.start()
    # The trajectory plane: a port server that serves nothing and never
    # trains (the lanes' episodes only need to arrive).
    from relayrl_tpu_torch.runtime.server import TrainingServer

    cfg = _stack_config(tmp_cwd, enabled=False)
    server_addrs, client_addrs = _zmq_stack()
    del server_addrs["serving_addr"]
    client_addrs["serving_addr"] = addr
    server = TrainingServer("REINFORCE", obs_dim=4, act_dim=3, env_dir=str(tmp_cwd),
                            config_path=cfg, hyperparams={**HP, "traj_per_epoch": 10_000},
                            device="cpu", **server_addrs)
    mux = MultiplexedRemoteClient(config_path=cfg, lanes=lanes, seed=40,
                                  **client_addrs)
    stream, serial = ZmqStreamingClient(addr), ZmqServingClient(addr)
    try:
        policy = build_policy(TF_ARCH, "cpu")
        params = policy.load_params(bundle.params)
        fn = make_keyed_batched_window_step(policy)
        keys = np.stack([prng_key(40 + i) for i in range(lanes)])
        windows = np.zeros((lanes, 16, 4), np.float32)
        lengths = np.zeros(lanes, np.int32)
        sent = [[] for _ in range(lanes)]
        for i in range(lanes):
            mux.trajectories[i]._on_send = sent[i].append
        rng = np.random.default_rng(17)
        for step in range(6):
            obs = [rng.standard_normal(4).astype(np.float32) for _ in range(lanes)]
            recs = mux.request_for_actions(obs, rewards=None if step == 0 else [0.5] * lanes)
            for i in range(lanes):
                lengths[i], _ = push_window(windows[i], lengths[i], obs[i])
            acts, aux, keys = fn(params, keys, windows, lengths, None)
            for i in range(lanes):
                _assert_served_equals(recs[i], np.asarray(acts[i]),
                                      {k: np.asarray(v[i]) for k, v in aux.items()})
        assert len(dispatched) == 6 and svc._m_batches["size"].total() == 6
        assert mux.inflight_high_water >= 2
        for i in range(lanes):
            mux.flag_last_action(i, 1.0, terminated=True)
            assert len(sent[i]) == 1
        # Streamed out of order == lock-step, on the stateless wire of an
        # MLP service bound beside it.
        mlp = _service(_bundle(MLP_ARCH), max_batch=4, batch_timeout_ms=2.0)
        mlp_addr = f"tcp://127.0.0.1:{free_port()}"
        mlp.bind_zmq(mlp_addr)
        mlp.start()
        s2, l2 = ZmqStreamingClient(mlp_addr), ZmqServingClient(mlp_addr)
        try:
            payloads = [pack_infer_request(f"s{i}", i + 1, prng_key(100 + i),
                                           rng.standard_normal(4).astype(np.float32), None)
                        for i in range(8)]
            waiters = [s2.submit(p, i + 1) for i, p in enumerate(payloads)]
            assert s2.inflight_high_water >= 2
            streamed = [s2.wait(w, WAIT_S) for w in reversed(waiters)][::-1]
            lockstep = [l2.request(p, i + 1, WAIT_S) for i, p in enumerate(payloads)]
            for a, b in zip(streamed, lockstep):
                assert a["code"] == b["code"] == 1 and a["key"] == b["key"]
                assert np.array_equal(a["act"], b["act"])
        finally:
            s2.close()
            l2.close()
            mlp.stop()
    finally:
        stream.close()
        serial.close()
        mux.disable_agent()
        svc.stop()
        server.disable_server()


def test_standalone_host_follows_publishes(tmp_cwd):
    """A ``StandaloneInferenceHost`` subscribes to a port server's model
    plane like an actor (v2 frames through ``apply_wire_swap``) and
    serves each published version to a thin client."""
    from relayrl_tpu_torch.runtime.inference import (
        RemoteActorClient,
        StandaloneInferenceHost,
    )
    from relayrl_tpu_torch.runtime.server import TrainingServer

    cfg = _stack_config(tmp_cwd, enabled=False)
    server_addrs, client_addrs = _zmq_stack()
    serving_addr = server_addrs.pop("serving_addr")
    server = TrainingServer("REINFORCE", obs_dim=4, act_dim=2, env_dir=str(tmp_cwd),
                            config_path=cfg, hyperparams=HP, device="cpu",
                            **server_addrs)
    sub = {k: v for k, v in client_addrs.items() if k != "serving_addr"}
    host = StandaloneInferenceHost(config_path=cfg, serving_addr=serving_addr,
                                   device="cpu", handshake_timeout_s=WAIT_S, **sub)
    client = RemoteActorClient(config_path=cfg, seed=5, identity="thin-sa",
                               **client_addrs)
    try:
        rng = np.random.default_rng(0)
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline and (
                server.stats["updates"] < 2 or host.service.version < server.algorithm.version):
            for _ in range(5):
                client.request_for_action(rng.standard_normal(4).astype(np.float32),
                                          reward=1.0)
            client.flag_last_action(1.0, terminated=True)
            time.sleep(0.05)
        assert server.stats["updates"] >= 2
        # The last episode may start an update after the loop's check:
        # wait until the server is drained and the host has followed.
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline and not (
                server.drain(timeout=1.0)
                and host.service.version == server.algorithm.version):
            time.sleep(0.05)
        assert host.service.version == server.algorithm.version
        assert host.service._wire_decoder is not None  # v2 frames applied
        client.request_for_action(np.zeros(4, np.float32))
        assert client.model_version == host.service.version
    finally:
        client.disable_agent()
        host.stop()
        server.disable_server()


@pytest.mark.parametrize("direction", ["jax_client_port_service",
                                       "port_client_jax_service"])
def test_cross_wire_zmq(tmp_cwd, direction):
    """A JAX ``RemoteActorClient`` served by a port server, and a port
    client served by a JAX server: each round-trips the other side's
    successor keys, every action is valid, and the episodes reach the
    other side's learner."""
    from relayrl_tpu.runtime.inference import RemoteActorClient as JaxClient
    from relayrl_tpu.runtime.server import TrainingServer as JaxServer
    from relayrl_tpu_torch.runtime.inference import RemoteActorClient
    from relayrl_tpu_torch.runtime.server import TrainingServer

    cfg = _stack_config(tmp_cwd)
    server_addrs, client_addrs = _zmq_stack()
    if direction == "jax_client_port_service":
        server = TrainingServer("REINFORCE", obs_dim=4, act_dim=2, env_dir=str(tmp_cwd),
                                config_path=cfg, hyperparams=HP, device="cpu",
                                **server_addrs)
        client = JaxClient(config_path=cfg, seed=3, identity="x-jax", **client_addrs)
        seen = server.inference
    else:
        server = JaxServer("REINFORCE", obs_dim=4, act_dim=2, env_dir=str(tmp_cwd),
                           config_path=cfg, hyperparams=HP, **server_addrs)
        client = RemoteActorClient(config_path=cfg, seed=3, identity="x-port",
                                   **client_addrs)
        seen = server.inference
    try:
        # The learner's update is built before the clients play, so the
        # wait for it below measures no compile.
        assert server.wait_warmup(timeout=WAIT_S)
        rng = np.random.default_rng(1)
        keys = [np.asarray(client._rng).copy()]
        for ep in range(2):
            for _ in range(5):
                rec = client.request_for_action(rng.standard_normal(4).astype(np.float32),
                                                reward=1.0)
                act = np.asarray(rec.act)
                assert act.dtype == np.int32 and act.shape == () and 0 <= int(act) < 2
                assert rec.data["logp_a"].dtype == np.float32
                assert np.isfinite(rec.data["logp_a"]) and np.isfinite(rec.data["v"])
                keys.append(np.asarray(client._rng).copy())
            client.flag_last_action(1.0, terminated=True)
        assert all(k.dtype == np.uint32 and k.shape == (2,) for k in keys)
        assert len({k.tobytes() for k in keys}) == len(keys)
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline and server.stats["updates"] < 1:
            time.sleep(0.05)
        assert server.stats["updates"] >= 1
        assert seen.version >= 0 and client.model_version >= 0
    finally:
        client.disable_agent()
        server.disable_server()
