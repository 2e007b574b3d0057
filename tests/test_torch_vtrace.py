"""The port's V-trace against the JAX package's and against goldens.

* The hand-unrolled goldens of ``tests/test_vtrace.py`` (the IMPALA
  paper's backward recursion in plain Python floats), at its clipping
  settings and its two exact edge cases.
* JAX ``vtrace`` against the port's on random padded batches up to
  T = 256, f32, to 1e-5.
* The on-policy identity: behavior equal to target gives the n-step
  return, and the pg advantage the TD form against it.
* The log-depth scan against a Python loop, with zero coefficients.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relayrl_tpu.ops.vtrace import vtrace as jax_vtrace
from relayrl_tpu_torch.ops import vtrace
from relayrl_tpu_torch.ops.vtrace import reverse_linear_scan
from tests.test_vtrace import reference_vtrace

TOL = 1e-5


def run_vtrace(behavior_logp, target_logp, rew, val, gamma, last_val,
               rho_bar=1.0, c_bar=1.0, pad_to=None):
    """One trajectory through the port's op as a [1, T] batch."""
    T = len(rew)
    width = pad_to or T

    def row(xs):
        out = np.zeros(width, np.float32)
        out[:T] = xs
        return torch.as_tensor(out)[None]

    valid = np.zeros(width, np.float32)
    valid[:T] = 1.0
    res = vtrace(row(behavior_logp), row(target_logp), row(rew), row(val),
                 torch.as_tensor(valid)[None], gamma,
                 last_val=torch.tensor([last_val], dtype=torch.float32),
                 rho_bar=rho_bar, c_bar=c_bar)
    return res.vs[0].numpy(), res.pg_adv[0].numpy(), res.rho[0].numpy()


B_LOGP = [-0.5, -1.2, -0.3, -2.0]
T_LOGP = [-0.7, -0.4, -1.1, -0.9]
REW = [1.0, 0.0, -0.5, 2.0]
VAL = [0.3, -0.2, 0.8, 0.1]


@pytest.mark.parametrize("rho_bar,c_bar", [
    (1.0, 1.0), (0.5, 0.5), (10.0, 10.0), (1.0, 0.7)])
def test_against_hand_recursion(rho_bar, c_bar):
    vs, pg, rho = run_vtrace(B_LOGP, T_LOGP, REW, VAL, 0.9, last_val=0.4,
                             rho_bar=rho_bar, c_bar=c_bar)
    ref_vs, ref_pg, ref_rho = reference_vtrace(
        B_LOGP, T_LOGP, REW, VAL, 0.9, 0.4, rho_bar, c_bar)
    np.testing.assert_allclose(rho, ref_rho, rtol=1e-5)
    np.testing.assert_allclose(vs, ref_vs, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pg, ref_pg, rtol=1e-5, atol=1e-6)


def test_clipped_and_downweighted_edges():
    """Both ratios clip (e^2 -> 1): vs = pg = [2, 2]. The opposite tail:
    a ratio e^-2 passes unclipped and scales targets and advantage."""
    vs, pg, rho = run_vtrace([-3.0, -3.0], [-1.0, -1.0], [1.0, 2.0],
                             [0.0, 0.0], 0.5, 0.0)
    np.testing.assert_allclose(rho, [1.0, 1.0], rtol=1e-6)
    np.testing.assert_allclose(vs, [2.0, 2.0], rtol=1e-6)
    np.testing.assert_allclose(pg, [2.0, 2.0], rtol=1e-6)
    ratio = float(np.exp(-2.0))
    vs, pg, rho = run_vtrace([-1.0], [-3.0], [1.0], [0.0], 0.9, 0.0)
    for got in (rho, vs, pg):
        np.testing.assert_allclose(got, [ratio], rtol=1e-5)


def test_on_policy_identity():
    """behavior == target with rho_bar, c_bar >= 1 telescopes to the
    discounted n-step return with bootstrap, padded or not."""
    rng = np.random.default_rng(0)
    T, gamma = 6, 0.97
    logp = rng.uniform(-2, -0.1, T).astype(np.float32)
    rew = rng.standard_normal(T).astype(np.float32)
    val = rng.standard_normal(T).astype(np.float32)
    last_val = float(rng.standard_normal())
    G = np.zeros(T + 1, np.float64)
    G[T] = last_val
    for t in reversed(range(T)):
        G[t] = rew[t] + gamma * G[t + 1]
    for pad_to in (None, 11):
        vs, pg, rho = run_vtrace(logp, logp, rew, val, gamma, last_val,
                                 pad_to=pad_to)
        np.testing.assert_allclose(rho[:T], np.ones(T), rtol=1e-6)
        np.testing.assert_allclose(vs[:T], G[:T], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(pg[:T], rew + gamma * G[1:] - val,
                                   rtol=1e-4, atol=1e-5)
        assert np.all(vs[T:] == 0) and np.all(pg[T:] == 0)


def _random_batch(rng, B, T):
    lengths = rng.integers(1, T + 1, B)
    lengths[0] = T
    valid = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    return {
        "behavior_logp": -rng.random((B, T)).astype(np.float32) * 2,
        "target_logp": -rng.random((B, T)).astype(np.float32) * 2,
        "rew": rng.standard_normal((B, T)).astype(np.float32),
        "val": rng.standard_normal((B, T)).astype(np.float32),
        "valid": valid,
        "last_val": rng.standard_normal(B).astype(np.float32),
    }


@pytest.mark.parametrize("B,T,rho_bar,c_bar", [
    (4, 1, 1.0, 1.0), (3, 17, 1.0, 0.7), (8, 64, 0.5, 1.0),
    (8, 256, 1.0, 1.0), (2, 255, 2.0, 2.0)])
def test_matches_jax_on_padded_batches(B, T, rho_bar, c_bar):
    batch = _random_batch(np.random.default_rng(T), B, T)
    args = ("behavior_logp", "target_logp", "rew", "val", "valid")
    want = jax_vtrace(*(jnp.asarray(batch[k]) for k in args), 0.99,
                      last_val=jnp.asarray(batch["last_val"]),
                      rho_bar=rho_bar, c_bar=c_bar)
    got = vtrace(*(torch.as_tensor(batch[k]) for k in args), 0.99,
                 last_val=torch.as_tensor(batch["last_val"]),
                 rho_bar=rho_bar, c_bar=c_bar)
    for name in ("vs", "pg_adv", "rho"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=TOL, atol=TOL, err_msg=name)


def test_scan_matches_loop_with_zero_coefficients():
    rng = np.random.default_rng(1)
    coeff = rng.random((3, 37)).astype(np.float32)
    coeff[:, ::5] = 0.0
    x = rng.standard_normal((3, 37)).astype(np.float32)
    want = np.zeros_like(x)
    carry = np.zeros(3, np.float32)
    for t in reversed(range(37)):
        carry = x[:, t] + coeff[:, t] * carry
        want[:, t] = carry
    got = reverse_linear_scan(torch.as_tensor(coeff), torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
