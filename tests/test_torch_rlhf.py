"""The port's RLHF plane (``relayrl_tpu_torch/rlhf``) against the JAX
package's, on the CPU, at the JAX tests' sizes.

- the programmatic scorer's three planes equal the JAX package's bit for
  bit; the reward model with the JAX model's params carried across agrees
  with the JAX ``score_batch_np`` within ``RM_TOL`` (f32 through one small
  transformer, summed in another order), and its own planes agree with
  each other bit for bit;
- the score stage: the same episode bytes, per record and columnar,
  through the JAX ``ScoreStage`` and the port's give the same bytes out,
  padded and sliced batches too;
- generation: a batch-of-1 ``GenerationStage`` over a ``VectorActorHost``
  ships the same bytes as a ``PolicyActor`` serving through its window at
  the same seed; the ``VectorAgent`` interceptor seam; the server's
  train-lag histogram; ``get_rlhf_params`` against the reference;
- the live plane over ZMQ on each tier (vector, anakin, remote) against a
  port IMPALA server with a frozen lower half: exact ingest accounting,
  every shipped episode carrying its score, the metric family, the frozen
  leaves unchanged.

About 40 s on the CPU.
"""

import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from relayrl_tpu import telemetry as jax_telemetry
from relayrl_tpu_torch import telemetry
from tests._util import free_port

VOCAB, PROMPT, MAX_NEW = 6, 2, 6
CTX = PROMPT + MAX_NEW
# The RM's f32 forward (one-hot embed, one or two blocks, value head)
# summed in another order than XLA's: a few ulps of a value near 1.
RM_TOL = 2e-6
FREEZE = "params/(obs_embed|pos_embed|block_0)/"


@pytest.fixture(autouse=True)
def _clean_planes():
    for mod in (telemetry, jax_telemetry):
        mod.reset_for_tests()
    yield
    for mod in (telemetry, jax_telemetry):
        mod.reset_for_tests()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _chains(seed, n, length=CTX, vocab=VOCAB):
    """Token windows with successor runs, so the programmatic scorer pays
    something: a random prompt, then tokens that continue the chain with
    probability 2/3 and are random otherwise (EOS included)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, vocab, (n, length)).astype(np.int32)
    for i in range(n):
        for j in range(PROMPT, length):
            if rng.random() < 2 / 3:
                tokens[i, j] = (tokens[i, j - 1] + 1) % vocab
    return tokens, rng.integers(1, length - PROMPT + 1, n).astype(np.int32)


# ---------------------------------------------------------------------------
# scorers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_programmatic_planes_bit_equal_jax(seed):
    from relayrl_tpu.rlhf.scorers import ProgrammaticScorer as JaxScorer
    from relayrl_tpu_torch.rlhf.scorers import ProgrammaticScorer

    tokens, gen_lens = _chains(seed, 16)
    ours, theirs = ProgrammaticScorer(VOCAB), JaxScorer(VOCAB)
    want = theirs.score_batch_np(tokens, PROMPT, gen_lens)
    assert want.sum() > 0
    jit_jax = jax.jit(jax.vmap(theirs.score_jax, in_axes=(0, None, 0)))
    np.testing.assert_array_equal(np.asarray(jit_jax(tokens, PROMPT, gen_lens)), want)
    got = ours.score_batch_np(tokens, PROMPT, gen_lens)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    tt = ours.score_torch(torch.from_numpy(tokens), PROMPT, torch.from_numpy(gen_lens))
    assert tt.dtype == torch.float32
    np.testing.assert_array_equal(tt.numpy(), want)
    for i in range(len(tokens)):
        assert ours.score_np(tokens[i], PROMPT, gen_lens[i]) == \
            theirs.score_np(tokens[i], PROMPT, gen_lens[i]) == want[i]


def _rm_pair(n_layers, seed=11):
    from relayrl_tpu.rlhf.scorers import RewardModelScorer as JaxRM
    from relayrl_tpu_torch.rlhf.scorers import RewardModelScorer

    theirs = JaxRM(vocab_size=VOCAB, context_len=CTX, d_model=16, n_layers=n_layers,
                   seed=seed)
    tree = jax.tree.map(np.asarray, theirs.params)
    ours = RewardModelScorer(vocab_size=VOCAB, context_len=CTX, d_model=16,
                             n_layers=n_layers, device="cpu", params=tree)
    return ours, theirs


@pytest.mark.parametrize("n_layers", [1, 2])
def test_reward_model_matches_jax(n_layers):
    """The JAX RM's params carried across (``params=`` goes through
    ``weights.params_from_jax``): the port's scores within RM_TOL of the
    JAX ``score_batch_np``, read at the clipped last generated position."""
    ours, theirs = _rm_pair(n_layers)
    tokens, gen_lens = _chains(n_layers + 5, 11)
    gen_lens[0] = 0   # read clips at the prompt's last position
    want = theirs.score_batch_np(tokens, PROMPT, gen_lens)
    got = ours.score_batch_np(tokens, PROMPT, gen_lens)
    assert got.dtype == np.float32 and got.shape == (11,)
    np.testing.assert_allclose(got, want, atol=RM_TOL, rtol=0)
    assert np.all(np.abs(got) < 1.0)


@pytest.mark.parametrize("rows", [1, 3, 8, 13])
def test_reward_model_planes_bit_equal(rows):
    """On the CPU the RM's planes agree bit for bit: each row alone
    (``score_np``), in a batch of any size (``score_batch_np``, chunked
    and padded to ``batch_rows``) and through ``score_torch``; a second
    instance from the same seed scores the same bits; scoring never
    touches the params."""
    from relayrl_tpu_torch.rlhf.scorers import RewardModelScorer

    a = RewardModelScorer(vocab_size=VOCAB, context_len=CTX, seed=7, device="cpu")
    b = RewardModelScorer(vocab_size=VOCAB, context_len=CTX, seed=7, device="cpu")
    before = {k: v.clone() for k, v in a.params.state_dict().items()}
    tokens, gen_lens = _chains(rows, rows)
    batch = a.score_batch_np(tokens, PROMPT, gen_lens)
    np.testing.assert_array_equal(b.score_batch_np(tokens, PROMPT, gen_lens), batch)
    np.testing.assert_array_equal(
        a.score_torch(torch.from_numpy(tokens), PROMPT, gen_lens).numpy(), batch)
    for i in range(rows):
        assert np.float32(a.score_np(tokens[i], PROMPT, gen_lens[i])) == batch[i], i
    for k, v in a.params.state_dict().items():
        assert torch.equal(v, before[k]), k
    other = RewardModelScorer(vocab_size=VOCAB, context_len=CTX, seed=8, device="cpu")
    assert not np.array_equal(other.score_batch_np(tokens, PROMPT, gen_lens), batch)


def test_unknown_scorer_and_device_refusals(tmp_cwd):
    """An unknown name raises the reference's ValueError; the RM, the
    named-scorer env and the scheduler never fall back quietly to the CPU;
    the scheduler refuses threefry keys."""
    from relayrl_tpu.rlhf.scorers import make_scorer as jax_make_scorer
    from relayrl_tpu_torch.envs import TokenGenEnv
    from relayrl_tpu_torch.rlhf import make_scorer
    from relayrl_tpu_torch.rlhf.scheduler import RlhfScheduler

    with pytest.raises(ValueError) as ours:
        make_scorer("nope")
    with pytest.raises(ValueError) as theirs:
        jax_make_scorer("nope")
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="rng_keys"):
        RlhfScheduler(rng_keys=np.zeros((4, 2), np.uint32), device="cpu")
    if not torch.cuda.is_available():
        for build in (lambda: make_scorer("reward_model"),
                      lambda: TokenGenEnv(scorer="reward_model"),
                      lambda: RlhfScheduler(config_path=None)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build()


# ---------------------------------------------------------------------------
# score stage
# ---------------------------------------------------------------------------

def _mlp_bundle(seed, obs_dim=CTX, act_dim=VOCAB):
    from relayrl_tpu_torch.models import build_policy
    from relayrl_tpu_torch.types.model_bundle import ModelBundle
    from relayrl_tpu_torch.weights import params_to_jax

    arch = {"kind": "mlp_discrete", "obs_dim": obs_dim, "act_dim": act_dim,
            "hidden_sizes": [16], "has_critic": True}
    params = build_policy(arch, "cpu").init_params(torch.Generator().manual_seed(seed))
    return ModelBundle(version=1, arch=arch, params=params_to_jax(params))


def _record_episode(seed):
    """One scorer-less TokenGen episode through a port PolicyActor (MLP),
    bver stamped as the generation stage stamps it: (payload, env)."""
    from relayrl_tpu_torch.envs import TokenGenEnv
    from relayrl_tpu_torch.runtime import PolicyActor

    sent = []
    actor = PolicyActor(_mlp_bundle(seed), on_send=sent.append, seed=seed, device="cpu")
    env = TokenGenEnv(vocab_size=VOCAB, prompt_len=PROMPT, max_new_tokens=MAX_NEW)
    obs, _ = env.reset(seed=seed)
    for _ in range(MAX_NEW):
        rec = actor.request_for_action(obs)
        rec.data["bver"] = np.int32(1)
        obs, _rew, term, _tr, _ = env.step(int(np.asarray(rec.act)))
        if term:
            actor.flag_last_action(0.0, terminated=True)
            break
    assert len(sent) == 1
    return sent[0], env


def _fused_frames(seed=0, lanes=2, unroll=24):
    """Whole TokenGen episodes as columnar frames from a port
    AnakinActorHost (the anakin tier's wire form, bver stamped)."""
    from relayrl_tpu_torch.models import build_policy
    from relayrl_tpu_torch.runtime.anakin import AnakinActorHost
    from relayrl_tpu_torch.types.model_bundle import ModelBundle
    from relayrl_tpu_torch.weights import params_to_jax

    arch = {"kind": "transformer_discrete", "obs_dim": CTX, "act_dim": VOCAB,
            "d_model": 16, "n_layers": 1, "n_heads": 2, "max_seq_len": CTX}
    params = build_policy(arch, "cpu").init_params(torch.Generator().manual_seed(seed))
    sent = []
    host = AnakinActorHost(
        ModelBundle(version=2, arch=arch, params=params_to_jax(params)), "TokenGen-v0",
        num_envs=lanes, unroll_length=unroll, record_bver=True, device="cpu",
        on_send=lambda lane, p: sent.append((lane, p)), seed=seed,
        vocab_size=VOCAB, prompt_len=PROMPT, max_new_tokens=MAX_NEW)
    host.rollout()
    assert len(sent) >= 4
    return sent


def _through_stages(payloads, batch):
    """The same (lane, payload) list through the JAX ScoreStage and the
    port's, programmatic scorer: the two emitted lists."""
    from relayrl_tpu.rlhf.scheduler import ScoreStage as JaxStage
    from relayrl_tpu.rlhf.scorers import ProgrammaticScorer as JaxScorer
    from relayrl_tpu_torch.rlhf.scheduler import ScoreStage
    from relayrl_tpu_torch.rlhf.scorers import ProgrammaticScorer

    out = []
    for stage_cls, scorer in ((JaxStage, JaxScorer(VOCAB)),
                              (ScoreStage, ProgrammaticScorer(VOCAB))):
        emitted = []
        stage = stage_cls(scorer, prompt_len=PROMPT, batch=batch,
                          emit_fn=lambda lane, p, _e=emitted: _e.append((lane, p)))
        for lane, payload in payloads:
            stage.submit(lane, payload)
        stage.close()
        out.append((emitted, stage.scored_snapshot()))
    return out


def test_extract_generation_matches_reference():
    from relayrl_tpu.rlhf.scheduler import extract_generation as jax_extract
    from relayrl_tpu.rlhf.scheduler import extract_generation_frame as jax_extract_frame
    from relayrl_tpu.types.columnar import parse_frame as jax_parse_frame
    from relayrl_tpu.types.trajectory import deserialize_actions as jax_deserialize
    from relayrl_tpu_torch.rlhf.scheduler import extract_generation, extract_generation_frame
    from relayrl_tpu_torch.types.columnar import parse_frame
    from relayrl_tpu_torch.types.trajectory import deserialize_actions

    for seed in range(4):
        payload, env = _record_episode(seed)
        tokens, gen_len, marker = extract_generation(deserialize_actions(payload), PROMPT)
        np.testing.assert_array_equal(tokens, env._tokens)
        assert gen_len == env._t and marker is not None and marker.act is None
        want = jax_extract(jax_deserialize(payload), PROMPT)
        assert tokens.tobytes() == want[0].tobytes() and gen_len == want[1]
    for _lane, frame in _fused_frames():
        tokens, gen_len = extract_generation_frame(parse_frame(frame), PROMPT)
        want = jax_extract_frame(jax_parse_frame(frame), PROMPT)
        assert tokens.tobytes() == want[0].tobytes() and gen_len == want[1] >= 1


@pytest.mark.parametrize("wire", ["records", "columnar"])
def test_score_stage_bytes_equal_reference(wire):
    """The same episodes through both packages' stages give the same
    bytes out: the terminal reward patched (the marker's, or the folded
    r[-1]), every other byte kept, and the same scores."""
    if wire == "records":
        payloads = [(i % 3, _record_episode(i)[0]) for i in range(5)]
    else:
        payloads = _fused_frames()
    (want, want_scores), (got, got_scores) = _through_stages(payloads, batch=4)
    assert got == want and len(got) == len(payloads)
    assert got_scores == want_scores and sum(got_scores) >= 0
    assert [p for _, p in got] != [p for _, p in payloads] or sum(got_scores) == 0


def test_score_stage_pads_and_slices():
    """A batch wider than the submissions pads with repeated rows: the
    scores of the real rows equal the single-row scores, and the bytes the
    reference's."""
    from relayrl_tpu_torch.rlhf.scheduler import extract_generation
    from relayrl_tpu_torch.rlhf.scorers import ProgrammaticScorer
    from relayrl_tpu_torch.types.trajectory import deserialize_actions

    payloads = [(i, _record_episode(10 + i)[0]) for i in range(3)]
    (want, _), (got, scores) = _through_stages(payloads, batch=8)
    assert got == want and len(got) == 3
    sc = ProgrammaticScorer(VOCAB)
    for (_lane, src), (_l, out), score in zip(payloads, got, scores):
        tokens, gen_len, _ = extract_generation(deserialize_actions(src), PROMPT)
        assert deserialize_actions(out)[-1].rew == score == sc.score_np(tokens, PROMPT, gen_len)


# ---------------------------------------------------------------------------
# generation, the interceptor seam, the lag histogram, the config
# ---------------------------------------------------------------------------

def test_generation_stage_bit_identical_to_policy_actor():
    """A batch-of-1 GenerationStage over a VectorActorHost ships the same
    bytes as a PolicyActor serving through its window (use_kv_cache=False)
    from the same seed on the same env stream, windows rolling."""
    from relayrl_tpu_torch.envs import SyncVectorEnv, TokenGenEnv
    from relayrl_tpu_torch.models import build_policy
    from relayrl_tpu_torch.rlhf.scheduler import GenerationStage
    from relayrl_tpu_torch.runtime import PolicyActor, VectorActorHost
    from relayrl_tpu_torch.types.model_bundle import ModelBundle
    from relayrl_tpu_torch.weights import params_to_jax

    max_new = 5
    arch = {"kind": "transformer_discrete", "obs_dim": PROMPT + max_new, "act_dim": VOCAB,
            "d_model": 16, "n_layers": 1, "n_heads": 2, "max_seq_len": max_new,
            "has_critic": True}
    params = build_policy(arch, "cpu").init_params(torch.Generator().manual_seed(42))
    bundle = ModelBundle(version=7, arch=arch, params=params_to_jax(params))

    def env_fn():
        return TokenGenEnv(vocab_size=VOCAB, prompt_len=PROMPT, max_new_tokens=max_new)

    stage_sent = []
    host = VectorActorHost(bundle, 1, seed=0, device="cpu",
                           on_send=lambda lane, p: stage_sent.append(p))
    stage = GenerationStage(host, SyncVectorEnv([env_fn]), seed=123)
    while len(stage_sent) < 6 and stage.rounds < 200:
        stage.run_round()
    assert len(stage_sent) >= 6 and stage.tokens_generated == stage.rounds

    actor_sent = []
    actor = PolicyActor(bundle, on_send=actor_sent.append, seed=0, device="cpu",
                        use_kv_cache=False)
    env, episode = env_fn(), 0
    obs, _ = env.reset(seed=123)
    while len(actor_sent) < len(stage_sent):
        rec = actor.request_for_action(obs)
        rec.data["bver"] = np.int32(actor.version)
        obs, _rew, term, _tr, _ = env.step(int(np.asarray(rec.act)))
        if term:
            actor.flag_last_action(0.0, terminated=True)
            episode += 1
            obs, _ = env.reset(seed=123 + episode)  # SyncVectorEnv's autoreset seeds
    assert actor_sent[:len(stage_sent)] == stage_sent


class _StubTransport:
    identity = "stub"

    def __init__(self):
        self.sent = []

    def send_trajectory(self, payload, agent_id=None):
        self.sent.append((agent_id, payload))


def test_send_interceptor_withholds_ships_and_reemits(tmp_cwd):
    """``VectorAgent._send_lane`` offers every lane episode to the
    interceptor: a returned payload ships at once, None withholds it, and
    ``emit_lane`` re-injects it later, through the spool, whose sequence
    numbers follow emission order."""
    from relayrl_tpu_torch.runtime.agent import VectorAgent
    from relayrl_tpu_torch.runtime.spool import TrajectorySpool

    held = []

    def intercept(lane, payload):
        if lane == 0:
            held.append((lane, payload))
            return None
        return payload + b"!"

    agent = VectorAgent(num_envs=2, device="cpu", start=False, send_interceptor=intercept)
    agent.transport = _StubTransport()
    agent.agent_ids = ["a.lane0", "a.lane1"]
    agent._send_lane(0, b"first")
    agent._send_lane(1, b"second")
    assert held == [(0, b"first")]
    assert agent.transport.sent == [("a.lane1", b"second!")]
    agent.emit_lane(*held.pop())
    assert agent.transport.sent[-1] == ("a.lane0", b"first")
    # With a spool, the seq is assigned at emission: the withheld episode
    # takes lane 0's first sequence number when it is re-emitted.
    sent = []
    agent.spool = TrajectorySpool(lambda p, tagged: sent.append(tagged))
    agent._send_lane(0, b"third")
    assert sent == [] and held
    agent.emit_lane(*held.pop())
    assert agent.spool.sent_counts() == {"a.lane0": 1} and len(sent) == 1


@pytest.mark.parametrize("wire", ["records", "columnar"])
def test_server_observes_behavior_lag(wire, tmp_cwd):
    """``_observe_behavior_lag``: one observation of ``dispatched_version -
    bver`` (floored at 0) per trajectory that carries bver, per record and
    columnar; none for one that does not."""
    from relayrl_tpu_torch.runtime.server import TrainingServer
    from relayrl_tpu_torch.types.columnar import parse_frame
    from relayrl_tpu_torch.types.trajectory import deserialize_actions

    telemetry.set_registry(telemetry.Registry(run_id="lag"))
    server = TrainingServer.__new__(TrainingServer)
    server._m_rlhf_train_lag = telemetry.get_registry().histogram(
        "relayrl_rlhf_train_lag_versions", buckets=(0.0, 1.0, 2.0, 4.0))

    class Algo:
        dispatched_version = 3

    if wire == "records":
        item = deserialize_actions(_record_episode(0)[0])   # bver 1
        bare = deserialize_actions(_record_episode(1)[0])
        for r in bare:
            (r.data or {}).pop("bver", None)
    else:
        item = parse_frame(_fused_frames()[0][1])            # bver 2
        bare = parse_frame(_fused_frames()[0][1])
        bare.aux = {k: v for k, v in bare.aux.items() if k != "bver"}
    server._observe_behavior_lag(item, Algo)
    server._observe_behavior_lag(bare, Algo)
    counts, total, n = server._m_rlhf_train_lag.totals()
    assert n == 1 and total == (2.0 if wire == "records" else 1.0)


def test_get_rlhf_params_matches_reference(tmp_path):
    from relayrl_tpu.config import ConfigLoader as JaxLoader
    from relayrl_tpu_torch.config import ConfigLoader

    for i, section in enumerate(({"vocab_size": "junk", "prompt_len": -3, "lanes": 0,
                                  "scorer": "nope", "generation_tier": "warp",
                                  "generation_unroll": 0, "pace_timeout_s": None,
                                  "rm_seed": -1, "max_episodes_per_version": "x"},
                                 {"scorer": "reward_model", "generation_tier": "anakin",
                                  "pace_timeout_s": 0.01, "score_batch": 3},
                                 {})):
        path = tmp_path / f"c{i}.json"
        path.write_text(json.dumps({"rlhf": section}))
        got = ConfigLoader(None, path, create_if_missing=False).get_rlhf_params()
        want = JaxLoader(None, path, create_if_missing=False).get_rlhf_params()
        assert got == want
    assert got["generation_unroll"] <= got["max_new_tokens"]


# ---------------------------------------------------------------------------
# the live plane
# ---------------------------------------------------------------------------

_HP = {"traj_per_epoch": 8, "model_kind": "transformer_discrete", "d_model": 16,
       "n_layers": 2, "n_heads": 2, "max_seq_len": CTX, "lr": 3e-3, "seed_salt": 0,
       "bucket_lengths": [CTX]}


def _addrs():
    server = {k: f"tcp://127.0.0.1:{free_port()}"
              for k in ("agent_listener_addr", "trajectory_addr", "model_pub_addr")}
    agent = {"agent_listener_addr": server["agent_listener_addr"],
             "trajectory_addr": server["trajectory_addr"],
             "model_sub_addr": server["model_pub_addr"]}
    return server, agent


def _config(tmp, tier, lanes=4, **extra):
    cfg = {"max_traj_length": 64,
           "learner": {"checkpoint_dir": "", "checkpoint_every_epochs": 1_000_000,
                       "freeze": FREEZE},
           "rlhf": {"vocab_size": VOCAB, "prompt_len": PROMPT, "max_new_tokens": MAX_NEW,
                    "scorer": "programmatic", "lanes": lanes, "score_batch": lanes,
                    "generation_tier": tier, "max_episodes_per_version": 8,
                    "pace_timeout_s": 1.0},
           **extra}
    path = os.path.join(str(tmp), "relayrl_config.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _live(tmp, tier, episodes=24, lanes=4, updates=2, extra=None, server_extra=None,
          agent_extra=None):
    """The scheduler on ``tier`` against a port IMPALA server over ZMQ:
    every shipped episode's terminal reward equals the programmatic score
    of its tokens, the accounting is exact, the server's lag histogram saw
    every trajectory, the frozen leaves did not move and the rest did."""
    from relayrl_tpu_torch.rlhf.scheduler import (
        RlhfScheduler,
        extract_generation,
        extract_generation_frame,
    )
    from relayrl_tpu_torch.rlhf.scorers import ProgrammaticScorer
    from relayrl_tpu_torch.runtime.server import TrainingServer
    from relayrl_tpu_torch.types.columnar import is_columnar_frame, parse_frame
    from relayrl_tpu_torch.types.trajectory import deserialize_actions

    config = _config(tmp, tier, lanes, **(extra or {}))
    server_addrs, agent_addrs = _addrs()
    telemetry.set_registry(telemetry.Registry(run_id=f"rlhf-{tier}"))
    server = TrainingServer("IMPALA", obs_dim=CTX, act_dim=VOCAB, env_dir=str(tmp),
                            hyperparams=dict(_HP), config_path=config, device="cpu",
                            **server_addrs, **(server_extra or {}))
    before = server.algorithm.bundle().params
    sched = None
    try:
        sched = RlhfScheduler(config_path=config, seed=0, identity=f"rlhf-{tier}",
                              device="cpu", handshake_timeout_s=60,
                              **agent_addrs, **(agent_extra or {}))
        shipped = []
        emit = sched.score_stage.emit_fn
        sched.score_stage.emit_fn = lambda lane, p: (shipped.append(p), emit(lane, p))
        stats = sched.run(episodes=episodes, deadline_s=120)
        assert stats["episodes_scored"] >= episodes
        sched.flush()
        deadline = time.monotonic() + 60
        while server.stats["updates"] < updates and time.monotonic() < deadline:
            time.sleep(0.05)
        assert server.stats["updates"] >= updates, "learner never trained"
        assert server.drain(timeout=60)
        scorer = ProgrammaticScorer(VOCAB)
        for payload in shipped:
            if is_columnar_frame(payload):
                dt = parse_frame(payload)
                tokens, gen_len = extract_generation_frame(dt, PROMPT)
                reward, bvers = float(dt.columns["r"][-1]), dt.aux["bver"].tolist()
            else:
                records = deserialize_actions(payload)
                tokens, gen_len, marker = extract_generation(records, PROMPT)
                reward = marker.rew
                bvers = [int(r.data["bver"]) for r in records if r.act is not None]
            assert reward == scorer.score_np(tokens, PROMPT, gen_len)
            assert all(0 <= b <= server.algorithm.version for b in bvers)
        acct = server.ingest_accounting()["agents"]
        sent = (sched.agent.spool.sent_counts() if sched.agent is not None else
                {k: v for c in sched._clients for k, v in c.spool.sent_counts().items()})
        assert len(acct) == lanes and sum(sent.values()) == len(shipped)
        for lane_id, row in acct.items():
            assert row["accepted"] == row["max_seq"] == sent[lane_id] and row["contiguous"]
        names = {m["name"] for m in telemetry.get_registry().snapshot()["metrics"]}
        for metric in ("relayrl_rlhf_generated_tokens_total",
                       "relayrl_rlhf_scored_episodes_total", "relayrl_rlhf_stage_seconds",
                       "relayrl_rlhf_lag_versions", "relayrl_rlhf_train_lag_versions"):
            assert metric in names, metric
        assert server._m_rlhf_train_lag.totals()[2] == server.stats["trajectories"]
        after = server.algorithm.bundle().params
        flat_before = jax.tree_util.tree_flatten_with_path(before)[0]
        flat_after = dict(jax.tree_util.tree_flatten_with_path(after)[0])
        frozen, moved = [], []
        for path, leaf in flat_before:
            name = "params/" + "/".join(k.key for k in path[1:])
            same = np.array_equal(leaf, flat_after[path])
            if name.startswith(("params/obs_embed/", "params/pos_embed/",
                                "params/block_0/")):
                frozen.append(same)
            else:
                moved.append(not same)
        assert len(frozen) >= 8 and all(frozen) and any(moved)
        assert server.stats["learner_errors"] == 0
        return sched, stats
    finally:
        if sched is not None:
            sched.close()
        server.disable_server()


def test_live_vector_tier(tmp_cwd):
    sched, stats = _live(tmp_cwd, "vector")
    assert stats["tokens_generated"] == sched.generation.rounds * 4


def test_live_anakin_tier(tmp_cwd):
    from relayrl_tpu_torch.rlhf.scheduler import FusedGenerationStage

    sched, stats = _live(tmp_cwd, "anakin")
    assert isinstance(sched.generation, FusedGenerationStage) and sched.venv is None
    assert stats["tokens_generated"] == sched.generation.rounds * 4 * 8


def test_live_remote_tier(tmp_cwd):
    serving_addr = f"tcp://127.0.0.1:{free_port()}"
    sched, _stats = _live(
        tmp_cwd, "remote", episodes=16, lanes=4,
        extra={"serving": {"enabled": True, "max_batch": 4, "batch_timeout_ms": 2.0,
                           "max_sessions": 8, "request_timeout_s": 10.0,
                           "infer_deadline_s": 30.0}},
        server_extra={"serving_addr": serving_addr},
        agent_extra={"serving_addr": serving_addr, "probe": False})
    assert sched.agent is None and len(sched._clients) == 4
