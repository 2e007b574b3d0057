"""The port's attention ops (relayrl_tpu_torch.ops) against the JAX package's.

On the CPU the port's ``flash_attention`` runs the kernel's plain version,
which is held here to the Pallas forward kernel run in interpret mode (as
tests/test_flash.py runs it) and to the JAX dense attention. The CUDA
kernel is held to that plain version by the last test, which needs a GPU
and the CUDA toolkit (chip_smoke.py runs the same comparison on the card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relayrl_tpu.ops import attention as jax_attention
from relayrl_tpu.ops.flash import _fwd as jax_flash_fwd
from relayrl_tpu_torch.ops import attention as port_attention
from relayrl_tpu_torch.ops.flash import flash_attention, flash_attention_plain

# The bars of tests/test_flash.py. f32: the same arithmetic summed in
# another order. bf16: p and O each take one bf16 rounding, at points that
# move with the block structure (the running max differs per block).
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
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
    """The kernel on q, k, v laid out as the model passes them (views of one
    fused qkv projection), at the T = 1, ragged and tiled lengths."""
    gen = torch.Generator().manual_seed(5)
    for causal in (True, False):
        for T in (1, 17, 64, 130):
            qkv = torch.randn((3, T, 3, 2, 32), generator=gen)
            q, k, v = qkv.to(cuda_device, _TORCH[dtype]).unbind(2)
            before = flash_attention.launches
            out, lse2 = flash_attention(q, k, v, causal)
            assert flash_attention.launches == before + 1
            ref_out, ref_lse2 = flash_attention_plain(q, k, v, causal)
            torch.testing.assert_close(out.float(), ref_out.float(),
                                       atol=TOL[dtype], rtol=0)
            torch.testing.assert_close(lse2, ref_lse2, atol=TOL[dtype], rtol=0)
    q = q.detach().requires_grad_(True)
    out, _ = flash_attention(q, k, v)
    with pytest.raises(NotImplementedError, match="K2/K3"):
        out.float().sum().backward()
