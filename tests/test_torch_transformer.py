"""The port's transformer policy against the JAX package's, on carried params.

Params come from the JAX ``init_params`` and load into the port through
``params_from_jax``; the same numpy inputs go through both policies. The
JAX package on the CPU resolves ``attention="flash"`` to its blockwise or
dense path, the port to the flash kernel's plain version: the same
function, so both are held to one bar.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from relayrl_tpu.models import build_policy as jax_build_policy
from relayrl_tpu_torch.models import build_policy
from relayrl_tpu_torch.weights import params_from_jax, params_to_jax

# f32: the same arithmetic in another summation order (the flash bar of
# tests/test_flash.py). bf16: the qkv/attn_out/mlp layers round to bf16 at
# places that differ between XLA and torch; the bf16 flash bar.
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
W = 32  # max_seq_len: the serving window


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    this module from crowding the other test workers' CPUs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arch(attention, precision, **extra):
    return {"kind": "transformer_discrete", "obs_dim": 4, "act_dim": 2,
            "d_model": 32, "n_layers": 2, "n_heads": 2, "max_seq_len": W,
            "attention": attention, "precision": precision, **extra}


def _pair(arch, seed=0):
    """(jax policy, numpy params tree, port policy, port params module)."""
    jp = jax_build_policy(arch)
    tree = jax.tree.map(np.asarray, jp.init_params(jax.random.PRNGKey(seed)))
    # jit: one compile per input shape instead of one per op
    jp = dataclasses.replace(jp, **{
        name: jax.jit(getattr(jp, name))
        for name in ("evaluate", "mode", "step_window", "mode_window")})
    tp = build_policy(arch, device="cpu")
    return jp, tree, tp, tp.load_params(tree)


def _close(got, want, precision):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=TOL[precision], rtol=TOL[precision])


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("attention", ["flash", "dense"])
def test_evaluate_matches_jax(attention, precision):
    jp, tree, tp, module = _pair(_arch(attention, precision))
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((2, 16, 4)).astype(np.float32)
    mask = np.ones((2, 16, 2), np.float32)
    mask[:, ::3, 1] = 0.0  # action 1 illegal every third step
    act = np.where(mask[..., 1] > 0, rng.integers(0, 2, (2, 16)), 0)
    with torch.no_grad():
        got = tp.evaluate(module, obs, act, mask)
        for g, w in zip(got, jp.evaluate(tree, obs, act, mask)):
            _close(g, w, precision)
        # one unbatched sequence and one bare observation
        for g, w in zip(tp.evaluate(module, obs[0], act[0]),
                        jp.evaluate(tree, obs[0], act[0])):
            _close(g, w, precision)
        for g, w in zip(tp.evaluate(module, obs[0, 0], act[0, 0]),
                        jp.evaluate(tree, obs[0, 0], act[0, 0])):
            assert g.shape == ()
            _close(g, w, precision)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("attention", ["flash", "dense"])
def test_step_window_matches_jax(attention, precision):
    """Stacked windows with per-lane lengths (empty, filling, full): the
    port's ``v`` and the ``logp_a`` of the action it drew equal the JAX
    policy's values for that action at the lane's readout row; the single
    window form agrees with the stacked one."""
    jp, tree, tp, module = _pair(_arch(attention, precision))
    rng = np.random.default_rng(1)
    ts = np.array([1, 9, W], np.int32)
    windows = rng.standard_normal((3, W, 4)).astype(np.float32)
    for lane, t in enumerate(ts):
        windows[lane, t:] = 0.0  # right zero padding past the real rows
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        act, aux = tp.step_window(module, gen, windows, ts)
        act1, aux1 = tp.step_window(module, torch.Generator().manual_seed(0),
                                    windows[0], int(ts[0]))
    assert act.dtype == torch.int64 and act.shape == (3,)
    assert act1.shape == () and int(act1) == int(act[0])
    for lane, t in enumerate(ts):
        acts = np.zeros((1, W), np.int32)
        acts[0, t - 1] = int(act[lane])
        logp, _, v = jp.evaluate(tree, windows[lane][None], acts)
        _close(aux["logp_a"][lane], logp[0, t - 1], precision)
        _close(aux["v"][lane], v[0, t - 1], precision)
        _, j_aux = jp.step_window(tree, jax.random.PRNGKey(lane),
                                  windows[lane], int(t))
        _close(aux["v"][lane], j_aux["v"], precision)
    _close(aux1["v"], aux["v"][0], precision)


@pytest.mark.parametrize("attention", ["flash", "dense"])
def test_greedy_matches_jax(attention):
    """``mode`` and ``mode_window`` pick the JAX policy's actions (f32: no
    bf16 rounding can flip a near tie), masks included."""
    jp, tree, tp, module = _pair(_arch(attention, "float32", act_dim=3))
    rng = np.random.default_rng(2)
    obs = rng.standard_normal((4, 12, 4)).astype(np.float32)
    mask = np.ones((3,), np.float32)
    mask[2] = 0.0
    with torch.no_grad():
        assert tp.mode(module, obs).tolist() == \
            np.asarray(jp.mode(tree, obs)).tolist()
        assert int(tp.mode(module, obs[0], mask)) == \
            int(jp.mode(tree, obs[0], mask))
        windows = np.zeros((4, W, 4), np.float32)
        windows[:, :12] = obs
        ts = np.array([1, 5, 12, 12], np.int32)
        got = tp.mode_window(module, windows, ts, np.stack([mask] * 4))
        for lane, t in enumerate(ts):
            want = jp.mode_window(tree, windows[lane], int(t), mask)
            assert int(got[lane]) == int(want) != 2


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_readout_mode_matches_full_forward(precision):
    """The window paths' readout mode (final layer for one row per lane)
    against the full forward read at the same rows."""
    _, _, _, module = _pair(_arch("flash", precision))
    rng = np.random.default_rng(3)
    obs = torch.from_numpy(rng.standard_normal((3, W, 4)).astype(np.float32))
    idx = torch.tensor([0, 13, W - 1])
    lanes = torch.arange(3)
    with torch.no_grad():
        logits, v = module(obs)
        row_logits, row_v = module(obs, readout_t=idx)
    _close(row_logits, logits[lanes, idx].numpy(), precision)
    _close(row_v, v[lanes, idx].numpy(), precision)


def test_params_round_trip():
    """flax tree -> module -> flax tree is exact (names, order, dtypes,
    values); weights the port draws load into the JAX policy and give its
    outputs."""
    jp, tree, tp, module = _pair(_arch("flash", "float32"))
    back = params_to_jax(module)
    flat, flat_back = (jax.tree_util.tree_flatten_with_path(t)[0]
                       for t in (tree, back))
    assert [p for p, _ in flat] == [p for p, _ in flat_back]
    for (path, a), (_, b) in zip(flat, flat_back):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    assert set(params_from_jax(tree)) == set(module.state_dict())

    drawn = tp.init_params(torch.Generator().manual_seed(7))
    drawn_tree = params_to_jax(drawn)
    obs = np.random.default_rng(4).standard_normal((2, 8, 4)).astype(np.float32)
    act = np.zeros((2, 8), np.int32)
    with torch.no_grad():
        for g, w in zip(tp.evaluate(drawn, obs, act),
                        jp.evaluate(drawn_tree, obs, act)):
            _close(g, w, "float32")


def test_flash_dispatch_rule(monkeypatch):
    """``attention="flash"`` takes the kernel when the length tiles by
    ``flash_block`` (every length up to it does), else blockwise when it
    tiles by ``attention_block``, else dense — the JAX resolver's rule."""
    from relayrl_tpu_torch.models import transformer
    from relayrl_tpu_torch.ops.flash import flash_attention_plain

    calls = []

    def recording(q, k, v, causal=True):
        calls.append(q.shape[1])
        return flash_attention_plain(q, k, v, causal)

    monkeypatch.setattr(transformer, "flash_attention", recording)
    attn = transformer._resolve_attention(
        {"attention": "flash", "flash_block": 8, "attention_block": 4})
    for T in (1, 5, 8, 12, 13, 16):
        q, k, v = (torch.randn(1, T, 2, 16) for _ in range(3))
        out = attn(q, k, v)
        assert out.shape == (1, T, 2, 16)
    assert calls == [1, 5, 8, 16]
    with pytest.raises(ValueError, match="unknown"):
        transformer._resolve_attention({"attention": "no_such_kind"})
