"""The port's GAE ops (relayrl_tpu_torch.ops.gae) against the JAX package's.

The same numpy inputs, ragged padded batches with a nonzero bootstrap
``last_val``, go through both. Bar: 1e-6 absolute and relative in f32, the
same sums taken in another order (the JAX scan is associative, the port's
a doubling scan).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relayrl_tpu.ops import gae as jax_gae
from relayrl_tpu_torch.ops import gae

TOL = 1e-6
LENGTHS = [16, 9, 1, 5]  # ragged: full, partial, one step, short


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    this module from crowding the other test workers' CPUs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(seed=0, lengths=LENGTHS, T=16):
    rng = np.random.default_rng(seed)
    valid = (np.arange(T)[None] < np.asarray(lengths)[:, None]).astype(np.float32)
    rew = rng.standard_normal(valid.shape).astype(np.float32) * valid
    val = rng.standard_normal(valid.shape).astype(np.float32) * valid
    last_val = rng.standard_normal(len(lengths)).astype(np.float32)
    return rew, val, valid, last_val


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("discount", [0.0, 0.5, 0.98 * 0.97, 1.0])
@pytest.mark.parametrize("T", [1, 7, 16, 256])
def test_discount_cumsum_matches_jax(discount, T):
    """At T = 256 the bar is 1e-5: undiscounted sums of up to 256 normal
    draws reach ~30, where one f32 ulp is ~2e-6 and the two scans round
    at different partial sums."""
    x = np.random.default_rng(T).standard_normal((3, T)).astype(np.float32)
    _close(gae.discount_cumsum(torch.from_numpy(x), discount),
           jax_gae.discount_cumsum(jnp.asarray(x), discount),
           TOL if T <= 16 else 1e-5)


def test_discount_cumsum_along_another_dim():
    x = np.random.default_rng(1).standard_normal((5, 3, 2)).astype(np.float32)
    _close(gae.discount_cumsum(torch.from_numpy(x), 0.9, dim=0),
           jax_gae.discount_cumsum(jnp.asarray(x), 0.9, axis=0))


def test_discount_cumsum_keeps_f32_precision_at_slice_length():
    """γλ = 0.98 · 0.97 over T = 256, the learner slice's bucket, against
    a float64 loop: no division by γλ^T (about 2e-6) anywhere."""
    x = np.random.default_rng(2).standard_normal((2, 256)).astype(np.float32)
    d = 0.98 * 0.97
    want = np.zeros(x.shape, np.float64)
    acc = np.zeros(2)
    for t in range(255, -1, -1):
        acc = x[:, t] + d * acc
        want[:, t] = acc
    got = gae.discount_cumsum(torch.from_numpy(x), d).double().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("gamma", [0.98, 1.0])
def test_rewards_to_go_matches_jax(gamma):
    rew, _, valid, _ = _batch(3)
    _close(gae.rewards_to_go(torch.from_numpy(rew), torch.from_numpy(valid), gamma),
           jax_gae.rewards_to_go(jnp.asarray(rew), jnp.asarray(valid), gamma))


@pytest.mark.parametrize("gamma,lam", [(0.98, 0.97), (0.99, 0.95), (0.98, 1.0)])
@pytest.mark.parametrize("with_last_val", [True, False])
def test_gae_advantages_match_jax(gamma, lam, with_last_val):
    """Ragged rows; the bootstrap enters at each row's last valid index."""
    rew, val, valid, last_val = _batch(4)
    t_last = torch.from_numpy(last_val) if with_last_val else None
    j_last = jnp.asarray(last_val) if with_last_val else None
    adv, ret = gae.gae_advantages(torch.from_numpy(rew), torch.from_numpy(val),
                                  torch.from_numpy(valid), gamma, lam, t_last)
    j_adv, j_ret = jax_gae.gae_advantages(jnp.asarray(rew), jnp.asarray(val),
                                          jnp.asarray(valid), gamma, lam, j_last)
    _close(adv, j_adv)
    _close(ret, j_ret)
    assert not adv[valid == 0].any() and not ret[valid == 0].any()


def test_bootstrap_enters_at_last_valid_index():
    """One step of reward 0 and value 0 with last_val 2: the advantage is
    γ · 2, whatever padding follows the step."""
    rew = torch.zeros(1, 4)
    valid = torch.tensor([[1.0, 0.0, 0.0, 0.0]])
    adv, _ = gae.gae_advantages(rew, torch.zeros(1, 4), valid, 0.9, 0.5,
                                torch.tensor([2.0]))
    assert adv.tolist() == [[pytest.approx(1.8), 0.0, 0.0, 0.0]]


@pytest.mark.parametrize("seed", [5, 6])
def test_masked_mean_std_and_normalize_match_jax(seed):
    x, _, valid, _ = _batch(seed)
    mean, std = gae.masked_mean_std(torch.from_numpy(x), torch.from_numpy(valid))
    j_mean, j_std = jax_gae.masked_mean_std(jnp.asarray(x), jnp.asarray(valid))
    _close(mean, j_mean)
    _close(std, j_std)
    _close(gae.normalize_advantages(torch.from_numpy(x), torch.from_numpy(valid)),
           jax_gae.normalize_advantages(jnp.asarray(x), jnp.asarray(valid)))
