"""Head dims the flash kernels are not instantiated for, and the wide
ones: the port against the JAX package.

The port's kernels take head dims 16, 32, 64, 128 and 256.
``flash_attention`` and the flash rings zero-pad a narrower head dim to the
next of them, on every device, run the kernels (on the CPU: their plain
versions) with every scale from the true head dim, and slice the results
back; a transformer asked to run the flash kernels on a CUDA device with a
head dim above 256 is refused when it is built. Here, on the CPU, the
padded path and head dims 128 and 256 are held to the JAX package's Pallas
kernels in interpret mode, which take any head dim, at the f32 bars of
tests/test_flash.py; and the refusal is checked without a GPU (building a
policy allocates nothing).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relayrl_tpu.ops.flash import _fwd as jax_flash_fwd
from relayrl_tpu.ops.flash import flash_attention as jax_flash_attention
from relayrl_tpu.parallel import make_mesh as jax_make_mesh
from relayrl_tpu.parallel import make_ring_flash_attention as jax_make_ring_flash
from relayrl_tpu.parallel.ring_flash import chunked_flash_local as jax_chunked_flash_local
from relayrl_tpu_torch.models import build_policy
from relayrl_tpu_torch.ops.flash import (
    check_rows_aligned,
    flash_attention,
    flash_attention_plain,
    pad_head_dim,
)
from relayrl_tpu_torch.parallel import make_mesh, make_ring_flash_attention
from relayrl_tpu_torch.parallel.ring_flash import chunked_flash_local

# tests/test_flash.py's f32 bars: the forward 2e-5 (the same arithmetic
# summed in another order, over more zero columns), gradients 5e-5.
TOL, GRAD_TOL = 2e-5, 5e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    this module from crowding the other test workers' CPUs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arrays(shape, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("D,width", [(8, 16), (24, 32), (48, 64), (1, 16), (96, 128),
                                     (65, 128), (129, 256), (192, 256), (255, 256)])
def test_pad_head_dim_pads_to_the_next_kernel_width(D, width):
    q, k = (torch.from_numpy(x) for x in _arrays((2, 5, 3, D), seed=D, n=2))
    (qp, kp), got_d = pad_head_dim(q, k)
    assert got_d == D
    for x, xp in ((q, qp), (k, kp)):
        assert xp.shape == (2, 5, 3, width)
        assert torch.equal(xp[..., :D], x) and not xp[..., D:].any()


@pytest.mark.parametrize("D", [16, 32, 64, 128, 256, 512])
def test_pad_head_dim_keeps_kernel_widths_and_wider(D):
    q = torch.zeros((1, 2, 1, D))
    (qp,), got_d = pad_head_dim(q)
    assert qp is q and got_d == D


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [8, 24, 96, 128, 192, 256])
def test_padded_flash_matches_pallas_interpret(D, causal):
    """O, lse2 and the gradients of ``sum(O * w)`` in q, k and v through
    the port's ``flash_attention`` at head dims 8, 24, 96 and 192 (padded to
    16, 32, 128 and 256) and 128 and 256 (kernel widths, unpadded), plain
    versions, against the JAX package's ``flash_attention`` in interpret
    mode."""
    q, k, v, w = _arrays((2, 17, 2, D), seed=D + causal)

    def out_and_grads(q, k, v):
        out, vjp = jax.vjp(lambda q, k, v: jax_flash_attention(
            q, k, v, causal, interpret=True), q, k, v)
        return out, vjp(jnp.asarray(w))

    want, want_grads = jax.jit(out_and_grads)(q, k, v)
    _, want_lse2 = jax_flash_fwd(*(jnp.asarray(x) for x in (q, k, v)), causal, 17, 17, True)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got, lse2 = flash_attention(tq, tk, tv, causal)
    assert got.shape == (2, 17, 2, D) and lse2.shape == (2, 2, 17)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse2.numpy(), np.asarray(want_lse2), atol=TOL, rtol=TOL)
    got_grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(w))
    for g, wg in zip(got_grads, want_grads):
        assert g.shape == (2, 17, 2, D)
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), atol=GRAD_TOL, rtol=0)


def test_padded_flash_scales_by_the_true_head_dim():
    """The padded path is the plain version at the true width: the same
    function, not the same function at the padded width's scale."""
    q, k, v, _ = (torch.from_numpy(x) for x in _arrays((2, 9, 2, 8), seed=3))
    got, lse2 = flash_attention(q, k, v, True)
    want, want_lse2 = flash_attention_plain(q, k, v, True)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    torch.testing.assert_close(lse2, want_lse2, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_padded_ring_flash_matches_jax(causal):
    """Output and gradients of ``sum(out * w)`` through the port's flash
    ring at head dim 8 (padded to 16, plain chunk versions) over an sp 4
    mesh of the CPU, against the JAX package's flash ring in interpret
    mode on 4 CPU devices."""
    _check_ring_flash_matches_jax(8, causal)


@pytest.mark.parametrize("D", [96, 128, 192, 256])
def test_wide_ring_flash_matches_jax(D):
    """The same causal ring at head dims 96 and 192 (padded to 128 and
    256), 128 and 256."""
    _check_ring_flash_matches_jax(D, True)


def _check_ring_flash_matches_jax(D, causal):
    q, k, v, w = _arrays((2, 64, 2, D), seed=7 + causal)
    jax_mesh = jax_make_mesh({"dp": 1, "fsdp": 1, "tp": 1, "sp": 4}, jax.devices()[:4])
    jax_ring = jax_make_ring_flash(jax_mesh, causal=causal, interpret=True)

    def out_and_grads(q, k, v):
        out, vjp = jax.vjp(jax_ring, q, k, v)
        return out, vjp(jnp.asarray(w))

    want, want_grads = jax.jit(out_and_grads)(q, k, v)
    ring = make_ring_flash_attention(make_mesh({"sp": 4}, [torch.device("cpu")] * 4),
                                     causal=causal)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = ring(tq, tk, tv)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    for g, wg in zip(torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(w)),
                     want_grads):
        assert g.shape == q.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), atol=GRAD_TOL, rtol=0)


def test_padded_chunked_flash_local_matches_jax():
    _check_chunked_flash_local_matches_jax(8)


@pytest.mark.parametrize("D", [96, 128, 256])
def test_wide_chunked_flash_local_matches_jax(D):
    _check_chunked_flash_local_matches_jax(D)


def _check_chunked_flash_local_matches_jax(D):
    q, k, v, _ = _arrays((2, 32, 2, D), seed=11)
    want = jax.jit(lambda q, k, v: jax_chunked_flash_local(
        q, k, v, n_chunks=2, causal=True, interpret=True))(q, k, v)
    got = chunked_flash_local(*(torch.from_numpy(x) for x in (q, k, v)), 2, True)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_bf16_rows_off_16_bytes_are_refused():
    rows = torch.zeros((2, 5, 4, 20), dtype=torch.bfloat16)[..., :16]  # 40-byte rows
    with pytest.raises(ValueError, match="16-byte"):
        check_rows_aligned("flash_attention", rows, rows, rows)
    check_rows_aligned("flash_attention", *torch.zeros((3, 2, 5, 4, 16)).unbind(0))
    check_rows_aligned("flash_attention", *torch.zeros(
        (2, 5, 3, 4, 16), dtype=torch.bfloat16).unbind(2))


def _arch(attention, d_model, n_heads):
    return {"kind": "transformer_discrete", "obs_dim": 4, "act_dim": 3,
            "d_model": d_model, "n_layers": 1, "n_heads": n_heads, "max_seq_len": 8,
            "attention": attention, "precision": "float32"}


@pytest.mark.parametrize("attention", ["flash", "ring"])
def test_cuda_transformer_refuses_head_dims_above_the_widest_kernel(attention):
    """Asked for a CUDA device, a transformer whose flash or ring attention
    would run the kernels at head dim 512, above the widest kernel (256),
    is refused when it is built, with the head dim and the limit named;
    nothing touches the device, so this holds on a machine without a GPU.
    On the CPU the same arch builds and runs (the plain versions take any
    head dim)."""
    arch = _arch(attention, d_model=1024, n_heads=2)
    with pytest.raises(ValueError, match=r"up to 256.*head dim 512"):
        build_policy(arch, device="cuda")
    policy = build_policy(arch, device="cpu")
    params = policy.init_params(torch.Generator().manual_seed(0))
    obs = torch.from_numpy(_arrays((2, 8, 4), seed=5, n=1)[0])
    with torch.no_grad():
        logp, ent, v = policy.evaluate(params, obs, torch.zeros((2, 8), dtype=torch.long))
    assert logp.shape == ent.shape == v.shape == (2, 8)
    assert all(torch.isfinite(x).all() for x in (logp, ent, v))


@pytest.mark.parametrize("attention,d_model,n_heads", [
    ("flash", 16, 2),     # head dim 8, tests/test_anakin.py's arch: padded
    ("ring", 128, 2),     # head dim 64
    ("flash", 256, 2),    # head dim 128
    ("ring", 256, 2),
    ("flash", 512, 2),    # head dim 256, the widest kernel
    ("ring", 512, 2),
    ("flash", 384, 2),    # head dim 192: padded to 256
    ("dense", 256, 2),    # head dim 128 without the flash kernels
])
def test_cuda_transformer_builds_within_the_limit(attention, d_model, n_heads):
    policy = build_policy(_arch(attention, d_model, n_heads), device="cuda")
    assert policy.device == torch.device("cuda")
