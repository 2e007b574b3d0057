"""The port's attention ops (relayrl_tpu_torch.ops) against the JAX package's.

On the CPU the port's ``flash_attention`` runs the kernels' plain versions,
forward and backward, through the same ``autograd.Function`` the CUDA path
takes. They are held here to the Pallas kernels run in interpret mode (as
tests/test_flash.py runs them), to the JAX dense attention and its
``jax.grad``, and to torch autograd through the plain forward. The CUDA
kernels are held to the plain versions by the last test, which needs a GPU
and the CUDA toolkit (chip_smoke.py runs the same comparisons on the card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relayrl_tpu.ops import attention as jax_attention
from relayrl_tpu.ops.flash import _bwd_pallas, _fwd
from relayrl_tpu_torch.ops import attention as port_attention
from relayrl_tpu_torch.ops.flash import (
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_plain,
)

# The Pallas forward and backward under jax.jit (causal, blocks and
# interpret static): one compile per case, and a backward case reuses its
# forward from the forward's grid, where eager interpret-mode calls
# re-trace every grid.
jax_flash_fwd = jax.jit(_fwd, static_argnums=(3, 4, 5, 6))
jax_flash_bwd = jax.jit(_bwd_pallas, static_argnums=(6, 7, 8, 9))

# The bars of tests/test_flash.py. f32: the same arithmetic summed in
# another order. bf16: p and O each take one bf16 rounding, at points that
# move with the block structure (the running max differs per block).
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# Gradients: 5e-5 in f32, the gradient bar of tests/test_flash.py (the
# backward sums over T keys and queries, in another order). bf16: 3e-2 of
# each gradient's max |value| — ds, p and the outputs each take one bf16
# rounding, at points that move with the summation order — and never below
# the f32 bar (at T = 1 dq is zero up to rounding).
GRAD_TOL = 5e-5


def _grad_tol(dtype, want) -> float:
    if dtype == "float32":
        return GRAD_TOL
    return max(GRAD_TOL, TOL[dtype] * float(np.abs(_f32(want)).max()))
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    this module from crowding the other test workers' CPUs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA flash kernel has "
                    "no CPU mode (chip_smoke.py holds it to the plain "
                    "version on the card)")
    return torch.device("cuda")


def _qkv(B, T, H, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, D)).astype(np.float32)
            for _ in range(3)]


def _to_jax(arrays, dtype):
    return [jnp.asarray(a).astype(_JNP[dtype]) for a in arrays]


def _to_torch(arrays, dtype):
    return [torch.from_numpy(a).to(_TORCH[dtype]) for a in arrays]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T,block_q,block_kv", [
    (32, 16, 16),
    (32, 16, 8),    # uneven blocks: the cross-block causal predicate
    (17, 17, 17),   # ragged length
    (1, 1, 1),      # the T = 1 validation step
])
def test_plain_matches_pallas_interpret(dtype, causal, T, block_q, block_kv):
    arrays = _qkv(2, T, 2, 16, seed=T)
    j_out, j_lse2 = jax_flash_fwd(*_to_jax(arrays, dtype), causal, block_q,
                                  block_kv, True)
    p_out, p_lse2 = flash_attention_plain(*_to_torch(arrays, dtype), causal)
    assert p_out.dtype == _TORCH[dtype] and p_out.shape == (2, T, 2, 16)
    assert p_lse2.dtype == torch.float32 and p_lse2.shape == (2, 2, T)
    np.testing.assert_allclose(_f32(p_out), _f32(j_out), atol=TOL[dtype],
                               rtol=TOL[dtype])
    np.testing.assert_allclose(p_lse2.numpy(), np.asarray(j_lse2),
                               atol=TOL[dtype], rtol=TOL[dtype])


BWD_SHAPES = [
    (32, 16, 16),
    (32, 16, 8),    # uneven blocks: the cross-block causal predicate
    (17, 17, 17),   # ragged length
    (1, 1, 1),      # one step
]


def _bwd_cases():
    """Every (shape, causal, dtype) case, ids as before. Tier 1 runs each
    shape at both causal flags, one dtype each, pairing them so that every
    shape meets both dtypes and every (causal, dtype) pair occurs; the
    other half is in the slow tier."""
    for i, (T, block_q, block_kv) in enumerate(BWD_SHAPES):
        for dtype in ("float32", "bfloat16"):
            for causal in (True, False):
                tier1 = (causal == (dtype == "float32")) == (i < 2)
                yield pytest.param(dtype, causal, T, block_q, block_kv,
                                   id=f"{T}-{block_q}-{block_kv}-{causal}-{dtype}",
                                   marks=() if tier1 else pytest.mark.slow)


@pytest.mark.parametrize("dtype,causal,T,block_q,block_kv", list(_bwd_cases()))
def test_plain_bwd_matches_pallas_interpret(dtype, causal, T, block_q, block_kv):
    """The backward's plain version against the dq and dk/dv Pallas
    kernels, on one forward's (O, lse2) and one upstream gradient."""
    arrays = _qkv(2, T, 2, 16, seed=10 + T)
    do = np.random.default_rng(T).standard_normal((2, T, 2, 16)).astype(np.float32)
    jq, jk, jv, jdo = _to_jax(arrays + [do], dtype)
    j_out, j_lse2 = jax_flash_fwd(jq, jk, jv, causal, block_q, block_kv, True)
    want = jax_flash_bwd(jq, jk, jv, j_out, j_lse2, jdo, causal, block_q,
                         block_kv, True)
    q, k, v, out, t_do = _to_torch(arrays + [np.array(_f32(j_out)), do], dtype)
    got = flash_attention_bwd_plain(q, k, v, out, torch.from_numpy(np.array(j_lse2)),
                                    t_do, causal)
    for g, w in zip(got, want):
        assert g.dtype == _TORCH[dtype] and g.shape == (2, T, 2, 16)
        np.testing.assert_allclose(_f32(g), _f32(w), atol=_grad_tol(dtype, w),
                                   rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_grads_match_jax_dense_grad(causal):
    """Gradients through the port's ``flash_attention`` (the plain backward
    on the CPU) against ``jax.grad`` of the JAX dense attention, f32."""
    arrays = _qkv(2, 24, 2, 16, seed=11)
    do = np.random.default_rng(12).standard_normal((2, 24, 2, 16)).astype(np.float32)

    def loss(q, k, v):
        return jnp.sum(jax_attention.dense_attention(q, k, v, causal=causal) * do)

    want = jax.grad(loss, argnums=(0, 1, 2))(*_to_jax(arrays, "float32"))
    q, k, v = (x.requires_grad_() for x in _to_torch(arrays, "float32"))
    out, _ = flash_attention(q, k, v, causal)
    got = torch.autograd.grad(out, (q, k, v), torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [1, 17, 32])
def test_plain_bwd_matches_autograd_of_plain_fwd(causal, T):
    """The plain backward equals torch autograd through the plain forward
    (f32), and ``flash_attention``'s CPU backward is the plain backward."""
    q, k, v = (x.requires_grad_() for x in _to_torch(_qkv(2, T, 2, 16, seed=13), "float32"))
    do = torch.from_numpy(
        np.random.default_rng(14).standard_normal((2, T, 2, 16)).astype(np.float32))
    out, lse2 = flash_attention_plain(q, k, v, causal)
    want = torch.autograd.grad(out, (q, k, v), do)
    got = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                    out.detach(), lse2.detach(), do, causal)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=GRAD_TOL, rtol=0)
    out, _ = flash_attention(q, k, v, causal)
    for g, w in zip(torch.autograd.grad(out, (q, k, v), do), got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_jax_dense(causal):
    arrays = _qkv(2, 24, 2, 16, seed=1)
    want = jax_attention.dense_attention(*_to_jax(arrays, "float32"),
                                         causal=causal)
    got, _ = flash_attention_plain(*_to_torch(arrays, "float32"), causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL["float32"], rtol=TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_offsets_match_jax(dtype):
    """Scalar offsets against the JAX op; a per-row offset vector (the
    batched readout row) against one JAX call per row."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((3, 2, 2, 16)).astype(np.float32)
    k, v = (rng.standard_normal((3, 8, 2, 16)).astype(np.float32)
            for _ in range(2))
    jq, jk, jv = _to_jax([q, k, v], dtype)
    tq, tk, tv = _to_torch([q, k, v], dtype)
    want = jax_attention.dense_attention(jq, jk, jv, q_offset=3, kv_offset=1)
    got = port_attention.dense_attention(tq, tk, tv, q_offset=3, kv_offset=1)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype])
    offsets = [0, 4, 7]
    got = port_attention.dense_attention(tq, tk, tv,
                                         q_offset=torch.tensor(offsets))
    for row, off in enumerate(offsets):
        want = jax_attention.dense_attention(jq[row:row + 1], jk[row:row + 1],
                                             jv[row:row + 1], q_offset=off)
        np.testing.assert_allclose(_f32(got[row:row + 1]), _f32(want),
                                   atol=TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_matches_jax(causal):
    arrays = _qkv(2, 32, 2, 16, seed=3)
    want = jax_attention.blockwise_attention(*_to_jax(arrays, "float32"),
                                             block_size=8, causal=causal)
    got = port_attention.blockwise_attention(*_to_torch(arrays, "float32"),
                                             block_size=8, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL["float32"], rtol=TOL["float32"])
    with pytest.raises(ValueError):
        port_attention.blockwise_attention(*_to_torch(arrays, "float32"),
                                           block_size=12)


def test_wrapper_takes_plain_version_on_cpu():
    q, k, v = _to_torch(_qkv(2, 9, 2, 16, seed=4), "float32")
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention_plain(q, k, v, causal=True)
    assert flash_attention.launches == before  # no kernel ran
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        flash_attention(*(x.to("meta") for x in (q, k, v)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_gpu(cuda_device, dtype):
    """The kernels on q, k, v laid out as the model passes them (views of
    one fused qkv projection), at the T = 1, ragged and tiled lengths (one
    64-row tile, one row past it) and head dims 16, 32 and 64, and 8 and 24
    (padded to 16 and 32): K1 against the plain forward, K2 and K3 (the
    backward through ``flash_attention``) against the plain backward."""
    gen = torch.Generator().manual_seed(5)
    for causal in (True, False):
        for T, D in ((1, 32), (17, 32), (64, 32), (65, 32), (130, 32), (65, 16),
                     (130, 64), (17, 8), (65, 24)):
            qkv = torch.randn((3, T, 3, 2, D), generator=gen)
            q, k, v = (x.requires_grad_() for x in
                       qkv.to(cuda_device, _TORCH[dtype]).unbind(2))
            before = (flash_attention.launches, flash_attention.dq_launches,
                      flash_attention.dkv_launches)
            out, lse2 = flash_attention(q, k, v, causal)
            ref_out, ref_lse2 = flash_attention_plain(q, k, v, causal)
            torch.testing.assert_close(out.float(), ref_out.float(),
                                       atol=TOL[dtype], rtol=0)
            torch.testing.assert_close(lse2, ref_lse2, atol=TOL[dtype], rtol=0)
            do = torch.randn(out.shape, generator=gen).to(cuda_device, _TORCH[dtype])
            got = torch.autograd.grad(out, (q, k, v), do)
            assert (flash_attention.launches, flash_attention.dq_launches,
                    flash_attention.dkv_launches) == tuple(n + 1 for n in before)
            want = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                             out.detach(), lse2, do, causal)
            for g, w in zip(got, want):
                torch.testing.assert_close(g.float(), w.float(),
                                           atol=_grad_tol(dtype, w.cpu()), rtol=0)
