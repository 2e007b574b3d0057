"""The port's on-device envs (``relayrl_tpu_torch/envs/device``) against the
JAX package's (``relayrl_tpu.envs.jax``) and their numpy twins, and the
three numpy envs the port copied (GridWorld, Bandit, TokenGen) against the
JAX package's.

Each device env steps 8 lanes on numpy-seeded actions from the JAX env's
own state, re-anchored before every step (a termination threshold can
flip on a one-ulp difference, so episodes never run free): integer envs
(Recall at noise 0, GridWorld, Bandit, TokenGen) match every field bit for
bit, CartPole and Pendulum match to ``atol = rtol = 2e-6`` per step, as
``tests/test_jax_envs.py`` holds the JAX envs to the numpy ones. The
autoreset is fed the JAX reset (the port's generators cannot give
threefry's bits), and the reset draws are held by their distributions.
About 25 s on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relayrl_tpu.envs.jax import make_jax
from relayrl_tpu.envs.jax import step_autoreset as jax_step_autoreset
from relayrl_tpu_torch.envs.device import DEVICE_ENVS, make_device, step_autoreset

ATOL = RTOL = 2e-6
LANES, STEPS = 8, 120
INTEGER_ENVS = ("Recall-v0", "GridWorld-v0", "Bandit-v0", "TokenGen-v0")


class CountOnes:
    """A scorer both planes run: the count of token 1 among the generated
    tokens, as numpy, JAX and batched torch."""

    @staticmethod
    def score_np(tokens, prompt_len, gen_len):
        return float(np.sum(tokens[prompt_len:prompt_len + gen_len] == 1))

    @staticmethod
    def score_jax(tokens, prompt_len, gen_len):
        pos = jnp.arange(tokens.shape[0])
        mine = (pos >= prompt_len) & (pos < prompt_len + gen_len)
        return jnp.sum((tokens == 1) & mine).astype(jnp.float32)

    @staticmethod
    def score_torch(tokens, prompt_len, gen_len):
        pos = torch.arange(tokens.shape[1])[None]
        mine = (pos >= prompt_len) & (pos < prompt_len + gen_len[:, None])
        return ((tokens == 1) & mine).sum(dim=1).to(torch.float32)


CASES = {
    "CartPole-v1": {"max_steps": 30},
    "Pendulum-v1": {"max_steps": 25},
    "Recall-v0": {"horizon": 8, "n_cues": 3},
    "GridWorld-v0": {"size": 3, "max_steps": 9},
    "Bandit-v0": {},
    "TokenGen-v0": {"vocab_size": 4, "prompt_len": 2, "max_new_tokens": 5,
                    "scorer": CountOnes()},
}


def _to_port(state) -> tuple:
    """A JAX env state (batched) as the port's state: the same fields as
    tensors, without the key Recall carries (the port draws its noise
    from the env generator)."""
    return tuple(torch.as_tensor(np.array(v)) for k, v in state._asdict().items()
                 if k != "key")


def _actions(env, rng):
    if env.action_space.shape == (1,):
        return rng.uniform(-2.5, 2.5, (LANES, 1)).astype(np.float32)
    return rng.integers(env.action_space.n, size=LANES).astype(np.int32)


def _check(env_id, got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if env_id in INTEGER_ENVS or got.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL, err_msg=what)


def _numpy_twin(env_id, kwargs):
    from relayrl_tpu_torch import envs

    kw = {k: v for k, v in kwargs.items()}
    twin = envs.make(env_id, **kw)
    twin.reset(seed=0)
    return twin


def _inject(env_id, twin, state, lane):
    """Set a numpy twin to lane ``lane`` of a (numpy) JAX state."""
    s = {k: np.asarray(v)[lane] for k, v in state._asdict().items()}
    if env_id == "CartPole-v1":
        twin._state, twin._t = s["state"].astype(np.float64), int(s["t"])
    elif env_id == "Pendulum-v1":
        twin._theta, twin._theta_dot = float(s["theta"]), float(s["theta_dot"])
        twin._t = int(s["t"])
    elif env_id == "Recall-v0":
        twin._cue, twin._t = int(s["cue"]), int(s["t"])
    elif env_id == "GridWorld-v0":
        twin._pos, twin._t = s["pos"].copy(), int(s["t"])
    elif env_id == "Bandit-v0":
        twin._ctx = int(s["ctx"])
    else:
        twin._tokens, twin._t = s["tokens"].copy(), int(s["t"])


@pytest.mark.parametrize("env_id", sorted(CASES))
def test_steps_match_jax_and_numpy(env_id):
    """Every step of the device env from the JAX env's state equals the
    JAX step (and the numpy twin's on lane 0), and ``step_autoreset``
    with the JAX reset injected equals the JAX ``step_autoreset``: the
    next state and observation and the pre-reset ``final_obs``."""
    kwargs = CASES[env_id]
    denv = make_device(env_id, device="cpu", **kwargs)
    jenv = make_jax(env_id, **kwargs)
    twin = _numpy_twin(env_id, kwargs)
    jstep = jax.jit(jax.vmap(jenv.step))
    jreset = jax.jit(jax.vmap(jenv.reset))
    jauto = jax.jit(jax.vmap(lambda k, s, a: jax_step_autoreset(jenv, k, s, a)))
    rng = np.random.default_rng(sum(map(ord, env_id)))
    keys = jax.random.split(jax.random.PRNGKey(3), LANES)
    jstate, _ = jreset(keys)
    ends = {"terminated": 0, "truncated": 0}
    for _ in range(STEPS):
        act = _actions(jenv, rng)
        tstate = type(denv.reset(torch.Generator().manual_seed(0), 1)[0])(*_to_port(jstate))
        want = jstep(jstate, jnp.asarray(act))
        got = denv.step(tstate, torch.as_tensor(act))
        for name, g, w in zip(("obs", "reward", "terminated", "truncated"), got[1:], want[1:]):
            _check(env_id, g.numpy(), w, f"{env_id} {name}")
        for g, w in zip(got[0], _to_port(want[0])):
            _check(env_id, g.numpy(), w.numpy(), f"{env_id} state")
        _inject(env_id, twin, jstate, 0)
        t_obs, t_rew, t_term, t_trunc, _ = twin.step(
            act[0] if act.ndim == 2 else int(act[0]))
        np.testing.assert_allclose(got[1][0].numpy(), t_obs, atol=ATOL, rtol=RTOL)
        if env_id in INTEGER_ENVS:
            np.testing.assert_array_equal(got[1][0].numpy(), t_obs)
        assert float(got[2][0]) == pytest.approx(t_rew, abs=ATOL, rel=RTOL)
        assert (bool(got[3][0]), bool(got[4][0])) == (t_term, t_trunc)
        # The autoreset, the JAX reset injected.
        split = jax.vmap(jax.random.split)(keys)
        reset = jreset(split[:, 1])
        keys, jnext, jobs, _, jterm, jtrunc, jfinal = jauto(keys, jstate, jnp.asarray(act))
        nxt, obs, _, term, trunc, final = step_autoreset(
            denv, tstate, torch.as_tensor(act),
            reset=(type(tstate)(*_to_port(reset[0])), torch.as_tensor(np.array(reset[1]))))
        _check(env_id, obs.numpy(), jobs, f"{env_id} autoreset obs")
        _check(env_id, final.numpy(), jfinal, f"{env_id} final_obs")
        for g, w in zip(nxt, _to_port(jnext)):
            _check(env_id, g.numpy(), w.numpy(), f"{env_id} autoreset state")
        ends["terminated"] += int(np.sum(jterm))
        ends["truncated"] += int(np.sum(jtrunc & ~jterm))
        jstate = jnext
    assert ends["terminated"] + ends["truncated"] >= LANES, ends


def test_recall_phase_matches_jax_at_any_horizon():
    """At a horizon that is not a power of two (phase 17's 300) the phase
    fraction still equals the JAX twin's bit for bit: both multiply by the
    float32 reciprocal."""
    denv = make_device("Recall-v0", device="cpu", horizon=300, n_cues=16)
    jenv = make_jax("Recall-v0", horizon=300, n_cues=16)
    t = np.arange(300, dtype=np.int32)
    state = type(denv.reset(torch.Generator().manual_seed(0), 1)[0])(
        cue=torch.zeros(300, dtype=torch.int32), t=torch.as_tensor(t))
    got = denv.step(state, torch.zeros(300, dtype=torch.int32))[1]
    jstate, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), 300))
    jstate = jstate._replace(cue=jnp.zeros(300, jnp.int32), t=jnp.asarray(t))
    want = jax.jit(jax.vmap(jenv.step))(jstate, jnp.zeros(300, jnp.int32))[1]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_autoreset_masks_and_final_obs():
    """Lanes that end take the reset's state and observation, and ship the
    pre-reset observation as ``final_obs``; the others keep their step,
    with ``final_obs`` equal to ``obs``."""
    env = make_device("GridWorld-v0", device="cpu", size=3, max_steps=4)
    gen = torch.Generator().manual_seed(1)
    state, _ = env.reset(gen, 4)
    state = type(state)(pos=torch.tensor([[2, 1], [0, 0], [1, 1], [2, 1]], dtype=torch.int32),
                        t=torch.tensor([0, 0, 3, 3], dtype=torch.int32))
    reset_state = type(state)(pos=torch.full((4, 2), 7, dtype=torch.int32),
                              t=torch.zeros(4, dtype=torch.int32))
    reset_obs = torch.full((4, 2), 7, dtype=torch.int32)
    act = torch.tensor([3, 1, 0, 3], dtype=torch.int32)  # right, down, up, right
    nxt, obs, rew, term, trunc, final = step_autoreset(env, state, act,
                                                       reset=(reset_state, reset_obs))
    assert term.tolist() == [True, False, False, True]
    assert trunc.tolist() == [False, False, True, True]
    assert rew.tolist() == [1.0, 0.0, 0.0, 1.0]
    assert final.tolist() == [[2, 2], [1, 0], [0, 1], [2, 2]]
    assert obs.tolist() == [[7, 7], [1, 0], [7, 7], [7, 7]]
    assert nxt.pos.tolist() == obs.tolist() and nxt.t.tolist() == [0, 1, 0, 0]


def test_autoreset_draws_every_lane_every_step():
    """The reset is drawn for every lane at every step, done or not: the
    env generator's stream advances alike whatever ends, so it does not
    depend on episode lengths."""
    env = make_device("CartPole-v1", device="cpu")
    offsets = []
    for action in (0, 1):
        gen = torch.Generator().manual_seed(5)
        state, _ = env.reset(gen, 16)
        for _ in range(40):
            state, *_ = step_autoreset(env, state, torch.full((16,), action), gen)
        offsets.append(torch.rand(1, generator=gen).item())
    assert offsets[0] == offsets[1]


def test_reset_distributions():
    """Bounds and moments of 4096 resets of each env, and the Recall
    distractor noise (drawn for every lane at every step) by its moments."""
    n, gen = 4096, torch.Generator().manual_seed(11)
    _, obs = make_device("CartPole-v1", device="cpu").reset(gen, n)
    assert obs.abs().max() <= 0.05 and abs(obs.mean()) < 0.002
    assert abs(obs.std() - 0.1 / 12 ** 0.5) < 0.002
    state, obs = make_device("Pendulum-v1", device="cpu").reset(gen, n)
    assert state.theta.abs().max() <= np.pi and state.theta_dot.abs().max() <= 1.0
    assert abs(state.theta.std() - 2 * np.pi / 12 ** 0.5) < 0.05
    np.testing.assert_allclose(obs[:, 0], torch.cos(state.theta), atol=1e-6)
    state, _ = make_device("Recall-v0", device="cpu", n_cues=4).reset(gen, n)
    counts = torch.bincount(state.cue.long(), minlength=4).float() / n
    assert (counts - 0.25).abs().max() < 0.03
    state, obs = make_device("GridWorld-v0", device="cpu", size=3).reset(gen, n)
    cells = torch.bincount((obs[:, 0] * 3 + obs[:, 1]).long(), minlength=9)
    assert cells[8] == 0 and (cells[:8].float() / n - 1 / 8).abs().max() < 0.03
    state, obs = make_device("Bandit-v0", device="cpu").reset(gen, n)
    assert (obs.sum(dim=1) == 1).all() and state.ctx.min() >= 0 and state.ctx.max() < 8
    state, obs = make_device("TokenGen-v0", device="cpu").reset(gen, n)
    assert obs[:, :3].min() >= 1 and obs[:, :3].max() <= 7 and (obs[:, 3:] == 0).all()
    noisy = make_device("Recall-v0", device="cpu", n_cues=4, noise=0.5)
    state, _ = noisy.reset(gen, n)
    state, obs, *_ = noisy.step(state, torch.zeros(n, dtype=torch.int32), gen)
    head = obs[:, :4]
    assert abs(head.mean()) < 0.02 and abs(head.std() - 0.5) < 0.02
    _, again, *_ = noisy.step(state, torch.zeros(n, dtype=torch.int32), gen)
    assert not torch.equal(again[:, :4], head)


def test_dtypes_and_registry():
    """Dtypes are pinned as the JAX envs pin them, ``DEVICE_ENVS`` keeps
    the JAX registry's ids, and ``list_envs`` reports the device plane."""
    from relayrl_tpu.envs.jax import JAX_ENVS
    from relayrl_tpu_torch.envs import list_envs

    assert sorted(DEVICE_ENVS) == sorted(JAX_ENVS)
    assert list_envs() == {"builtin": sorted(JAX_ENVS), "device": sorted(JAX_ENVS)}
    with pytest.raises(ValueError, match="unknown device env"):
        make_device("Pong-v5", device="cpu")
    integer_obs = {"GridWorld-v0", "Bandit-v0", "TokenGen-v0"}
    for env_id, kwargs in CASES.items():
        env = make_device(env_id, device="cpu", **kwargs)
        state, obs = env.reset(torch.Generator().manual_seed(0), 3)
        act = torch.zeros((3, 1)) if env_id == "Pendulum-v1" else torch.zeros(3, dtype=torch.int32)
        _, obs, rew, term, trunc = env.step(state, act)
        assert obs.dtype == (torch.int32 if env_id in integer_obs else torch.float32)
        assert rew.dtype == torch.float32
        assert term.dtype == trunc.dtype == torch.bool
        assert all(v.dtype in (torch.int32, torch.float32) for v in state)
        assert obs.shape == (3, env.obs_dim)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_device("CartPole-v1")


@pytest.mark.parametrize("env_id", ["GridWorld-v0", "Bandit-v0", "TokenGen-v0"])
def test_numpy_copies_match_jax_package(env_id):
    """The three numpy envs the port copied give the JAX package's bits at
    the same seeds and actions."""
    from relayrl_tpu import envs as jax_envs
    from relayrl_tpu_torch import envs

    kwargs = {"TokenGen-v0": {"scorer": CountOnes.score_np}}.get(env_id, {})
    ours, theirs = envs.make(env_id, **kwargs), jax_envs.make(env_id, **kwargs)
    rng = np.random.default_rng(2)
    for episode in range(20):
        a, _ = ours.reset(seed=episode)
        b, _ = theirs.reset(seed=episode)
        np.testing.assert_array_equal(a, b)
        for _ in range(60):
            act = int(rng.integers(ours.action_space.n))
            got, want = ours.step(act), theirs.step(act)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:4] == want[1:4]
            if got[2] or got[3]:
                break
    with pytest.raises(ValueError, match="item 15"):
        envs.make("TokenGen-v0", scorer="length")
