"""Sequence-parallel ring attention and the sp learner: the port against the JAX package.

The same numpy inputs from a seed go through both packages, on the 8
virtual CPU devices of ``tests/conftest.py`` (JAX) and on meshes that name
the CPU device 8 times (the port). On the CPU the port's chunk wrappers
run their plain versions; the JAX chunk kernels run in interpret mode
(``_build_chunk_calls(..., interpret=True)``). The JAX ring on the CPU
takes its scan ring inside the transformer, so the transformer and learner
cases hold the port's flash ring to it: the same function. The CUDA
kernels are held to the plain versions by the last test, which needs a GPU
(chip_smoke.py runs the same comparisons on the card).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relayrl_tpu.algorithms.reinforce import ReinforceState as JaxState
from relayrl_tpu.algorithms.reinforce import make_optimizers as jax_make_optimizers
from relayrl_tpu.algorithms.reinforce import make_reinforce_update as jax_make_update
from relayrl_tpu.models import build_policy as jax_build_policy
from relayrl_tpu.ops.flash import _prescale_q as jax_prescale_q
from relayrl_tpu.parallel import make_mesh as jax_make_mesh
from relayrl_tpu.parallel import make_ring_attention as jax_make_ring_attention
from relayrl_tpu.parallel import make_ring_flash_attention as jax_make_ring_flash
from relayrl_tpu.parallel import make_sharded_update as jax_make_sharded_update
from relayrl_tpu.parallel import place_batch as jax_place_batch
from relayrl_tpu.parallel import place_state as jax_place_state
from relayrl_tpu.parallel import resolve_mesh_shape as jax_resolve_mesh_shape
from relayrl_tpu.parallel import use_mesh as jax_use_mesh
from relayrl_tpu.parallel.ring_flash import _build_chunk_calls
from relayrl_tpu.parallel.ring_flash import chunked_flash_local as jax_chunked_flash_local
from relayrl_tpu.parallel.ring_flash import pick_chunk_block as jax_pick_chunk_block
from relayrl_tpu_torch.algorithms.onpolicy import read_metrics
from relayrl_tpu_torch.algorithms.reinforce import (
    ReinforceState,
    make_optimizers,
    make_reinforce_update,
)
from relayrl_tpu_torch.models import build_policy
from relayrl_tpu_torch.models import transformer as port_transformer
from relayrl_tpu_torch.ops.attention import dense_attention
from relayrl_tpu_torch.parallel import (
    current_mesh,
    make_mesh,
    make_ring_attention,
    make_ring_flash_attention,
    make_sharded_update,
    place_batch,
    place_state,
    resolve_mesh_shape,
    use_mesh,
)
from relayrl_tpu_torch.parallel import ring_flash
from relayrl_tpu_torch.parallel.ring_flash import (
    MODE_DIAG,
    MODE_FULL,
    MODE_SKIP,
    chunk_dkv,
    chunk_dkv_plain,
    chunk_dq,
    chunk_dq_plain,
    chunk_fwd,
    chunk_fwd_plain,
    chunked_flash_local,
    pick_chunk_block,
    prescale_q,
)
from relayrl_tpu_torch.weights import params_to_jax

CPU = torch.device("cpu")
# The bars of tests/test_flash.py. Forward: 2e-5 in f32 (the same
# arithmetic summed in another order), 3e-2 in bf16 (p and O each take one
# bf16 rounding, at points that move with the block structure). Gradients:
# 5e-5 in f32; in bf16 3e-2 of each buffer's max |value| (ds and p take one
# bf16 rounding each), never below the f32 bar.
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
GRAD_TOL = 5e-5
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
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA ring chunk kernels "
                    "have no CPU mode (chip_smoke.py holds them to their plain "
                    "versions on the card)")
    return torch.device("cuda")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _grad_tol(dtype, want) -> float:
    if dtype == "float32":
        return GRAD_TOL
    return max(GRAD_TOL, TOL[dtype] * float(np.abs(_f32(want)).max()))


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# -- the chunk kernels' plain versions vs the Pallas chunk kernels ------------

B, C, H, D = 2, 16, 2, 16
# (chunk length, head dim) of the plain-vs-Pallas chunk cases: every head
# dim the CUDA kernels instantiate, and a chunk that is not a multiple of
# 16 (the tensor-core kernels' fragment height).
CHUNK_SHAPES = [(16, 16), (24, 32), (16, 64), (16, 128)]


def _bhcd_to_jax(x: torch.Tensor):
    """Port state ``[B, H, C, D]`` / ``[B, H, C]`` -> the Pallas layout
    ``[BH, C, D]`` / ``[BH, C, 1]``."""
    a = _f32(x)
    return jnp.asarray(a.reshape(a.shape[0] * a.shape[1], a.shape[2], -1))


def _bchd_to_jax(x: torch.Tensor, dtype):
    b, c, h, d = x.shape
    return jnp.asarray(_f32(x).transpose(0, 2, 1, 3).reshape(b * h, c, d)).astype(_JNP[dtype])


def _from_jax(x, like: torch.Tensor) -> np.ndarray:
    return np.asarray(x).reshape(like.shape)


def _chunk_inputs(dtype, seed, c=C, d=D):
    """Prescaled queries, two K/V chunks, do, and lse2/delta of the
    forward over both chunks (so every p <= 1), in the port's layouts."""
    rng = np.random.default_rng(seed)
    t = _TORCH[dtype]
    q, k0, v0, k1, v1, do = (torch.from_numpy(_randn(rng, B, c, H, d)).to(t)
                             for _ in range(6))
    qs = prescale_q(q)
    oml = ring_flash._init_state(qs)
    for kb, vb in ((k0, v0), (k1, v1)):
        oml = chunk_fwd_plain(MODE_FULL, qs, kb, vb, *oml)
    out, l_safe = ring_flash._finalize_chunk_state(oml[0], oml[2], t)
    lse2 = oml[1] + torch.log2(l_safe)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return qs, (k0, v0), (k1, v1), do, lse2, delta


@functools.lru_cache(maxsize=None)
def _jitted_chunk_calls(c, d, dtype):
    """The JAX chunk kernels (8-row blocks, interpret mode) under
    ``jax.jit``: each compiles once per shape and is then reused by every
    case and call at that shape, where an eager interpret-mode call
    re-traces its grid each time."""
    return tuple(jax.jit(f) for f in _build_chunk_calls(c, d, 8, 8, dtype, True))


def test_prescale_matches_jax():
    rng = np.random.default_rng(0)
    q = _randn(rng, B, C, H, D)
    for dtype in ("float32", "bfloat16"):
        got = prescale_q(torch.from_numpy(q).to(_TORCH[dtype]))
        want = jax_prescale_q(jnp.asarray(q).astype(_JNP[dtype]))
        assert got.dtype == _TORCH[dtype]
        np.testing.assert_array_equal(_f32(got), _f32(want))


def _chunk_cases():
    """Every (shape, kernel, mode, dtype) case, ids as before. Tier 1 runs
    each shape and kernel in both modes at one dtype, alternating, so that
    every shape and every kernel meets both dtypes; the other dtype's cases
    are in the slow tier."""
    for i, (c, d) in enumerate(CHUNK_SHAPES):
        for j, kernel in enumerate(("fwd", "dq", "dkv")):
            tier1 = ("float32", "bfloat16")[(i + j) % 2]
            for mode in (MODE_FULL, MODE_DIAG):
                for dtype in ("float32", "bfloat16"):
                    yield pytest.param(c, d, kernel, mode, dtype,
                                       id=f"C{c}-D{d}-{kernel}-{mode}-{dtype}",
                                       marks=() if dtype == tier1 else pytest.mark.slow)


@pytest.mark.parametrize("c,d,kernel,mode,dtype", list(_chunk_cases()))
def test_chunk_plain_matches_pallas_interpret(c, d, kernel, mode, dtype):
    """Each plain version against its Pallas kernel (8-row blocks, two or
    three per chunk, so DIAG runs interior, masked and skipped blocks), on
    a carried state: one FULL call on chunk 0, then the call under test on
    chunk 1. The chunk shapes cover every head dim the CUDA kernels
    instantiate, which the card holds to these plain versions."""
    qs, (k0, v0), (k1, v1), do, lse2, delta = _chunk_inputs(dtype, mode, c, d)
    j_fwd, j_dq, j_dkv = _jitted_chunk_calls(c, d, dtype)
    jq, jk0, jv0, jk1, jv1, jdo = (_bchd_to_jax(x, dtype) for x in (qs, k0, v0, k1, v1, do))
    jlse, jdelta = _bhcd_to_jax(lse2), _bhcd_to_jax(delta)
    full, under_test = jnp.array([MODE_FULL], jnp.int32), jnp.array([mode], jnp.int32)
    if kernel == "fwd":
        got = chunk_fwd_plain(MODE_FULL, qs, k0, v0, *ring_flash._init_state(qs))
        got = chunk_fwd_plain(mode, qs, k1, v1, *got)
        want = j_fwd(full, jq, jk0, jv0, *(_bhcd_to_jax(x) for x in ring_flash._init_state(qs)))
        want = j_fwd(under_test, jq, jk1, jv1, *want)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(_f32(g), _from_jax(w, g), atol=TOL[dtype],
                                       rtol=TOL[dtype])
        return
    zero = ring_flash._zero_acc(qs)
    if kernel == "dq":
        got = [chunk_dq_plain(mode, qs, k1, v1, do, lse2, delta,
                              chunk_dq_plain(MODE_FULL, qs, k0, v0, do, lse2, delta, zero))]
        want = [j_dq(under_test, jq, jk1, jv1, jdo, jlse, jdelta,
                     j_dq(full, jq, jk0, jv0, jdo, jlse, jdelta, _bhcd_to_jax(zero)))]
    else:
        got = chunk_dkv_plain(mode, qs, k1, v1, do, lse2, delta,
                              *chunk_dkv_plain(MODE_FULL, qs, k0, v0, do, lse2, delta,
                                               zero, zero))
        want = j_dkv(under_test, jq, jk1, jv1, jdo, jlse, jdelta,
                     *j_dkv(full, jq, jk0, jv0, jdo, jlse, jdelta, _bhcd_to_jax(zero),
                            _bhcd_to_jax(zero)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (B, H, c, d)
        w = _from_jax(w, g)
        np.testing.assert_allclose(_f32(g), w, atol=_grad_tol(dtype, w), rtol=0)


def test_skip_launches_nothing_and_passes_the_carry_through():
    qs, (k0, v0), _, do, lse2, delta = _chunk_inputs("float32", seed=3)
    counts = (chunk_fwd.launches, chunk_dq.launches, chunk_dkv.launches)
    oml = ring_flash._init_state(qs)
    acc = ring_flash._zero_acc(qs)
    for fwd in (chunk_fwd, chunk_fwd_plain):
        assert all(a is b for a, b in zip(fwd(MODE_SKIP, qs, k0, v0, *oml), oml))
    for dq in (chunk_dq, chunk_dq_plain):
        assert dq(MODE_SKIP, qs, k0, v0, do, lse2, delta, acc) is acc
    for dkv in (chunk_dkv, chunk_dkv_plain):
        dk, dv = dkv(MODE_SKIP, qs, k0, v0, do, lse2, delta, acc, oml[0])
        assert dk is acc and dv is oml[0]
    # CPU tensors run the plain versions: the same values, no launch.
    got = chunk_fwd(MODE_DIAG, qs, k0, v0, *oml)
    for g, w in zip(got, chunk_fwd_plain(MODE_DIAG, qs, k0, v0, *oml)):
        assert torch.equal(g, w)
    assert (chunk_fwd.launches, chunk_dq.launches, chunk_dkv.launches) == counts
    with pytest.raises(ValueError):
        chunk_fwd(MODE_FULL, *(x.to("meta") for x in (qs, k0, v0, *oml)))


# -- the rings ----------------------------------------------------------------

def _qkv_w(seed, t=64, b=2, h=2, d=16):
    rng = np.random.default_rng(seed)
    return [_randn(rng, b, t, h, d) for _ in range(4)]


def _meshes(spec):
    n = spec.get("dp", 1) * spec.get("sp", 1)
    full = {"dp": 1, "fsdp": 1, "tp": 1, "sp": 1, **spec}
    return jax_make_mesh(full, jax.devices()[:n]), make_mesh(spec, [CPU] * n)


def _check_ring(port_ring, jax_ring, seed):
    """Output and the gradients of ``sum(out * w)`` in q, k, v (f32)."""
    q, k, v, w = _qkv_w(seed)

    def out_and_grads(q, k, v, w):
        out, vjp = jax.vjp(jax_ring, q, k, v)
        return out, vjp(w)

    # jit: the interpret-mode kernels inside the ring would otherwise
    # re-enter the interpreter op by op.
    want, want_grads = jax.jit(out_and_grads)(q, k, v, w)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = port_ring(tq, tk, tv)
    got_grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(w))
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(_f32(got), np.asarray(want), atol=TOL["float32"],
                               rtol=TOL["float32"])
    for g, wg in zip(got_grads, want_grads):
        np.testing.assert_allclose(_f32(g), np.asarray(wg), atol=GRAD_TOL, rtol=0)


@pytest.mark.parametrize("spec,causal", [
    ({"sp": 2}, True), ({"dp": 2, "sp": 4}, True), ({"sp": 4}, True),
    ({"sp": 4}, False)])
def test_ring_flash_matches_jax(spec, causal):
    jax_mesh, mesh = _meshes(spec)
    _check_ring(make_ring_flash_attention(mesh, causal=causal),
                jax_make_ring_flash(jax_mesh, causal=causal, interpret=True), seed=1)


@pytest.mark.parametrize("spec,causal", [
    ({"dp": 2, "sp": 4}, True), ({"sp": 8}, True), ({"sp": 4}, False)])
def test_scan_ring_matches_jax(spec, causal):
    jax_mesh, mesh = _meshes(spec)
    _check_ring(make_ring_attention(mesh, causal=causal),
                jax_make_ring_attention(jax_mesh, causal=causal), seed=2)


def test_ring_shards_share_one_device_without_aliasing():
    """On a ring whose 4 shards share one device, every rotation hands a
    shard the very tensors its predecessor holds; the flash ring (fresh
    kernel outputs) and the scan ring agree with dense attention, forward
    and backward, and the inputs are untouched."""
    _, mesh = _meshes({"sp": 4})
    q, k, v, w = (torch.from_numpy(x) for x in _qkv_w(5))
    before = [x.clone() for x in (q, k, v)]
    leaves = [x.requires_grad_() for x in (q, k, v)]
    want = dense_attention(*leaves, causal=True)
    want_grads = torch.autograd.grad(want, leaves, w)
    for make in (make_ring_flash_attention, make_ring_attention):
        got = make(mesh)(*leaves)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL["float32"])
        for g, wg in zip(torch.autograd.grad(got, leaves, w), want_grads):
            np.testing.assert_allclose(_f32(g), _f32(wg), atol=GRAD_TOL)
    for x, b in zip(leaves, before):
        assert torch.equal(x.detach(), b)


@pytest.mark.parametrize("causal,n", [(True, 2), (True, 4), (False, 2)])
def test_chunked_flash_local_matches_jax(causal, n):
    q, k, v, _ = _qkv_w(4)
    want = jax.jit(lambda q, k, v: jax_chunked_flash_local(
        q, k, v, n_chunks=n, causal=causal, interpret=True))(q, k, v)
    got = chunked_flash_local(*(torch.from_numpy(x) for x in (q, k, v)), n, causal)
    np.testing.assert_allclose(_f32(got), np.asarray(want), atol=TOL["float32"],
                               rtol=TOL["float32"])


@pytest.mark.parametrize("chunk", [3, 4, 8, 24, 64, 1000, 4096])
def test_pick_chunk_block_matches_jax(chunk):
    assert pick_chunk_block(chunk) == jax_pick_chunk_block(chunk)


@pytest.mark.parametrize("spec,n", [
    ({"dp": -1}, 8), ({"dp": 2, "sp": 4}, 8), ({"dp": -1, "sp": 4}, 8),
    ({"dp": -1, "sp": -1}, 8), ({"sp": 3}, 8), ({"dp": -1, "sp": 3}, 8),
    ({"tp": 0}, 1)])
def test_resolve_mesh_shape_matches_jax(spec, n):
    try:
        want = jax_resolve_mesh_shape(spec, n)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            resolve_mesh_shape(spec, n)
        assert str(got.value) == str(err)
    else:
        assert resolve_mesh_shape(spec, n) == want


def test_mesh_matches_jax_layout():
    jax_mesh, mesh = _meshes({"dp": 2, "sp": 4})
    assert mesh.shape == dict(jax_mesh.shape)
    assert mesh.devices.shape == jax_mesh.devices.shape
    ids = np.vectorize(lambda d: d.id)(jax_mesh.devices)
    # The JAX mesh's device ids along sp for dp row 1 are the port's shard
    # positions: the same row-major layout.
    assert list(ids[1, 0, 0, 0, :, 0]) == [4, 5, 6, 7]
    assert mesh.axis_devices("sp", dp=1) == [CPU] * 4
    with pytest.raises(ValueError):
        mesh.axis_devices("sp", sp=0)


def test_make_mesh_needs_devices_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default devices are valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh({"sp": 1})


def test_use_mesh_nesting():
    _, outer = _meshes({"sp": 2})
    _, inner = _meshes({"sp": 4})
    assert current_mesh() is None
    with use_mesh(outer):
        assert current_mesh() is outer
        with use_mesh(inner):
            assert current_mesh() is inner
        assert current_mesh() is outer
        with pytest.raises(KeyError), use_mesh(inner):
            raise KeyError("unwinds")
        assert current_mesh() is outer
    assert current_mesh() is None


# -- the transformer and the learner ----------------------------------------

OBS, ACT = 4, 3


def _arch(precision="float32", attention="ring"):
    return {"kind": "transformer_discrete", "obs_dim": OBS, "act_dim": ACT,
            "d_model": 32, "n_layers": 2, "n_heads": 2, "max_seq_len": 32,
            "attention": attention, "attention_block": 16, "has_critic": True,
            "precision": precision}


def _tree(arch, seed=0):
    return jax.tree.map(np.asarray,
                        jax_build_policy(arch).init_params(jax.random.PRNGKey(seed)))


@pytest.fixture
def ring_spy(monkeypatch):
    """Which ring the transformer builds: a list of "flash"/"scan"."""
    built = []
    for name, tag in (("make_ring_flash_attention", "flash"),
                      ("make_ring_attention", "scan")):
        make = getattr(port_transformer, name)

        def spy(mesh, _make=make, _tag=tag):
            built.append(_tag)
            return _make(mesh)
        monkeypatch.setattr(port_transformer, name, spy)
    return built


def test_untileable_chunk_raises_and_transformer_takes_scan_ring(ring_spy):
    # T = 32 over sp = 8 leaves 4-row chunks (< the 8-row tile).
    jax_mesh, mesh = _meshes({"sp": 8})
    q, k, v, _ = (torch.from_numpy(x) for x in _qkv_w(6, t=32))
    with pytest.raises(ValueError, match="does not tile"):
        make_ring_flash_attention(mesh)(q, k, v)
    with pytest.raises(ValueError, match="does not tile"):
        chunked_flash_local(q, k, v, 8)
    arch = _arch()
    tree = _tree(arch)
    obs = _randn(np.random.default_rng(7), 2, 32, OBS)
    act = np.zeros((2, 32), np.int32)
    with jax_use_mesh(jax_mesh):
        want = jax.jit(jax_build_policy(arch).evaluate)(tree, obs, act)
    policy = build_policy(arch, device="cpu")
    with use_mesh(mesh), torch.no_grad():
        got = policy.evaluate(policy.load_params(tree), obs, act)
    assert ring_spy == ["scan"] * arch["n_layers"]
    for g, w in zip(got, want):
        np.testing.assert_allclose(_f32(g), np.asarray(w), atol=TOL["float32"],
                                   rtol=TOL["float32"])


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("spec", [None, {"dp": 2, "sp": 4}])
def test_ring_evaluate_matches_jax(ring_spy, spec, precision):
    """``evaluate`` of ``attention="ring"`` under a dp 2 x sp 4 mesh (the
    port's flash ring, 8-row chunks) and with no mesh (blockwise), against
    the JAX policy on the same params."""
    arch = _arch(precision)
    tree = _tree(arch)
    rng = np.random.default_rng(8)
    obs = _randn(rng, 2, 32, OBS)
    mask = np.ones((2, 32, ACT), np.float32)
    mask[:, ::3, 2] = 0.0
    act = np.where(mask[..., 2] > 0, rng.integers(0, ACT, (2, 32)), 0)
    policy = build_policy(arch, device="cpu")
    module = policy.load_params(tree)
    jax_eval = jax.jit(jax_build_policy(arch).evaluate)
    if spec is None:
        want = jax_eval(tree, obs, act, mask)
        with torch.no_grad():
            got = policy.evaluate(module, obs, act, mask)
        assert ring_spy == []
    else:
        jax_mesh, mesh = _meshes(spec)
        with jax_use_mesh(jax_mesh):
            want = jax_eval(tree, obs, act, mask)
        with use_mesh(mesh), torch.no_grad():
            got = policy.evaluate(module, obs, act, mask)
        assert ring_spy == ["flash"] * arch["n_layers"]
    for g, w in zip(got, want):
        np.testing.assert_allclose(_f32(g), np.asarray(w, np.float32),
                                   atol=TOL[precision], rtol=TOL[precision])


PI_LR, VF_LR, GAMMA, LAM, VF_ITERS = 3e-4, 1e-3, 0.98, 0.97, 2
UPDATE_SPEC = {"dp": 2, "sp": 4}
# The JAX package's error for a ring shard_map nested in its pipeline's:
# inside the outer shard_map every mesh axis is manual, so the inner one's
# mesh differs from the context mesh.
JAX_NESTED_SHARD_MAP = "context mesh .* should match the mesh passed to shard_map"
# One update in f32, at the learner slice's bars: metrics at rtol 1e-4
# (atol 1e-6 for AdvMean, ~0 by construction); params at atol 1e-5, except
# the key third of each qkv bias, whose gradient is zero in exact
# arithmetic: both sides step on rounding noise, each held to Adam's step
# bound.
METRIC_RTOL, METRIC_ATOL, PARAM_ATOL = 1e-4, 1e-6, 1e-5


def _update_batch(seed=0, b=4, t=32):
    rng = np.random.default_rng(seed)
    valid = (np.arange(t)[None] < np.array([[32], [19], [8], [1]])).astype(np.float32)
    return {
        "obs": _randn(rng, b, t, OBS) * valid[..., None],
        "act": (rng.integers(0, ACT, (b, t)) * valid).astype(np.int32),
        "act_mask": np.ones((b, t, ACT), np.float32),
        "rew": _randn(rng, b, t) * valid,
        "val": _randn(rng, b, t) * valid,
        "logp": -rng.random((b, t)).astype(np.float32) * valid,
        "valid": valid,
        "last_val": np.array([0.0, 0.5, -0.3, 0.0], np.float32),
    }


@pytest.fixture(scope="module")
def jax_sp_update():
    """The JAX package's sequence-parallel update (dp 2 x sp 4, time
    sharded) from params seed 0 on :func:`_update_batch`: (params tree,
    new params tree, metrics)."""
    arch = _arch()
    tree = _tree(arch)
    jax_mesh, _ = _meshes(UPDATE_SPEC)
    tx_pi, tx_vf = jax_make_optimizers(tree, PI_LR, VF_LR)
    state = JaxState(params=tree, pi_opt_state=tx_pi.init(tree),
                     vf_opt_state=tx_vf.init(tree), rng=jax.random.PRNGKey(1),
                     step=jnp.int32(0))
    update = jax_make_update(jax_build_policy(arch), PI_LR, VF_LR, VF_ITERS, GAMMA,
                             LAM, True)
    sharded = jax_make_sharded_update(update, jax_mesh, state, donate_state=False,
                                      shard_time=True)
    new, metrics = sharded(jax_place_state(state, jax_mesh),
                           jax_place_batch(_update_batch(), jax_mesh, shard_time=True))
    return (tree, jax.tree.map(np.asarray, new.params),
            {k: float(v) for k, v in metrics.items()})


def _leaves(tree):
    return {jax.tree_util.keystr(p): v
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("spec,ring", [(UPDATE_SPEC, "flash"), ({"sp": 8}, "scan")])
def test_sp_reinforce_update_matches_jax(jax_sp_update, ring_spy, spec, ring):
    """One REINFORCE update through ``make_sharded_update(...,
    shard_time=True)``: the port's flash ring (8-row chunks under dp 2 x
    sp 4) and its scan ring (4-row chunks under sp 8) against the JAX
    package's dp 2 x sp 4 update."""
    tree, want_params, want = jax_sp_update
    arch = _arch()
    policy = build_policy(arch, device="cpu")
    params = policy.load_params(tree)
    state = ReinforceState(params, *make_optimizers(params, PI_LR, VF_LR))
    _, mesh = _meshes(spec)
    sharded = make_sharded_update(make_reinforce_update(policy, VF_ITERS, GAMMA, LAM, True),
                                  mesh, state, shard_time=True)
    new, metrics = sharded(place_state(state, mesh), _update_batch())
    assert new.step == 1 and set(ring_spy) == {ring}
    got = read_metrics(metrics)
    assert set(got) == set(want)
    for key, value in want.items():
        atol = METRIC_ATOL if key == "AdvMean" else 0.0
        assert got[key] == pytest.approx(value, rel=METRIC_RTOL, abs=atol), key
    g, w, i = _leaves(params_to_jax(new.params)), _leaves(want_params), _leaves(tree)
    assert g.keys() == w.keys()
    for path in g:
        if path.endswith("['qkv']['bias']"):
            d = g[path].shape[0] // 3
            for side in (g, w):
                np.testing.assert_array_less(np.abs(side[path][d:2 * d] - i[path][d:2 * d]),
                                             PI_LR * (1 + 1e-3))
            g[path], w[path] = (np.delete(x[path], np.s_[d:2 * d]) for x in (g, w))
        np.testing.assert_allclose(g[path], w[path], atol=PARAM_ATOL, rtol=0,
                                   err_msg=path)


@pytest.mark.parametrize("axis", ["fsdp", "tp", "ep", "pp"])
def test_sharded_update_with_sp_and_another_axis(axis, ring_spy):
    """``{axis: 2, sp: 2}`` with the flash ring: fsdp (gathered params),
    tp (no ``dense_N`` leaf in a transformer: nothing splits) and ep (the
    MoE family's expert groups) compose with the ring, and the update
    equals the unsharded update at this file's bars; pp with the ring
    raises, in the JAX package too (its ring shard_map cannot nest in its
    pipeline's)."""
    kind = {"ep": "transformer_moe_discrete",
            "pp": "transformer_pp_discrete"}.get(axis, "transformer_discrete")
    arch = {**_arch(), "kind": kind}
    tree = _tree(arch)
    spec = {axis: 2, "sp": 2}
    policy = build_policy(arch, device="cpu")
    update = make_reinforce_update(policy, VF_ITERS, GAMMA, LAM, True)
    mesh = make_mesh(spec, [CPU] * 4)
    if axis == "pp":
        with pytest.raises(ValueError, match=JAX_NESTED_SHARD_MAP):
            with jax_use_mesh(jax_make_mesh(spec, jax.devices()[:4])):
                jax.jit(jax_build_policy(arch).evaluate)(
                    tree, np.zeros((2, 32, OBS), np.float32), np.zeros((2, 32), np.int32))
        state = place_state(ReinforceState(policy.load_params(tree), None, None), mesh)
        with pytest.raises(ValueError, match="inside the pipeline"):
            make_sharded_update(update, mesh, state, shard_time=True)(state, _update_batch())
        return
    sides = {}
    for side in ("mesh", "plain"):
        params = policy.load_params(tree)
        state = ReinforceState(params, *make_optimizers(params, PI_LR, VF_LR))
        if side == "mesh":
            sharded = make_sharded_update(update, mesh, state, shard_time=True)
            new, metrics = sharded(place_state(state, mesh), _update_batch())
        else:
            new, metrics = update(state, {k: torch.as_tensor(v)
                                          for k, v in _update_batch().items()})
        sides[side] = (_leaves(params_to_jax(new.params)), read_metrics(metrics))
    assert set(ring_spy) == {"flash"}
    (g, got), (w, want) = sides["mesh"], sides["plain"]
    for key, value in want.items():
        atol = METRIC_ATOL if key == "AdvMean" else 0.0
        assert got[key] == pytest.approx(value, rel=METRIC_RTOL, abs=atol), key
    i = _leaves(tree)
    for path in g:
        if path.endswith("['qkv']['bias']"):
            d = g[path].shape[0] // 3
            for leaves in (g, w):
                np.testing.assert_array_less(np.abs(leaves[path][d:2 * d] - i[path][d:2 * d]),
                                             PI_LR * (1 + 1e-3))
            g[path], w[path] = (np.delete(x[path], np.s_[d:2 * d]) for x in (g, w))
        np.testing.assert_allclose(g[path], w[path], atol=PARAM_ATOL, rtol=0, err_msg=path)


def test_place_batch_checks_the_split():
    _, mesh = _meshes(UPDATE_SPEC)
    batch = _update_batch()
    placed = place_batch(batch, mesh, shard_time=True)
    assert all(isinstance(x, torch.Tensor) and x.device == CPU for x in placed.values())
    with pytest.raises(ValueError, match="does not split"):
        place_batch({k: v[:, :30] if v.ndim >= 2 else v for k, v in batch.items()},
                    mesh, shard_time=True)
    with pytest.raises(ValueError, match="does not split"):
        place_batch({k: v[:3] for k, v in batch.items()}, mesh)


# -- the CUDA kernels ---------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_kernels_match_plain_on_gpu(cuda_device, dtype):
    """K4, K5 and K6 against their plain versions on the card, on q, k, v
    laid out as the model passes them (views of one fused projection) and
    a carried state, in both modes, at C 8, 64, 65 (one row past the
    tensor-core kernels' 64-row tile) and 130 and head dims 16, 32, 64 and
    128;
    then the flash ring through the kernels against dense attention,
    forward and backward."""
    gen = torch.Generator().manual_seed(9)
    t = _TORCH[dtype]
    for c, d in ((8, 32), (64, 32), (65, 32), (65, 16), (130, 64), (65, 128)):
        qkv = torch.randn((2, c, 3, 2, d), generator=gen).to(cuda_device, t)
        q, k, v = qkv.unbind(2)
        do = torch.randn((2, c, 2, d), generator=gen).to(cuda_device, t)
        qs = prescale_q(q)
        carry = chunk_fwd_plain(MODE_FULL, qs, k, v, *ring_flash._init_state(qs))
        out, l_safe = ring_flash._finalize_chunk_state(carry[0], carry[2], t)
        lse2 = carry[1] + torch.log2(l_safe)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        acc = chunk_dq_plain(MODE_FULL, qs, k, v, do, lse2, delta, ring_flash._zero_acc(qs))
        for mode in (MODE_FULL, MODE_DIAG):
            counts = (chunk_fwd.launches, chunk_dq.launches, chunk_dkv.launches)
            cases = (
                (chunk_fwd(mode, qs, k, v, *carry), chunk_fwd_plain(mode, qs, k, v, *carry)),
                ((chunk_dq(mode, qs, k, v, do, lse2, delta, acc),),
                 (chunk_dq_plain(mode, qs, k, v, do, lse2, delta, acc),)),
                (chunk_dkv(mode, qs, k, v, do, lse2, delta, acc, acc),
                 chunk_dkv_plain(mode, qs, k, v, do, lse2, delta, acc, acc)))
            assert (chunk_fwd.launches, chunk_dq.launches, chunk_dkv.launches) == tuple(
                n + 1 for n in counts)
            for got, want in cases:
                for g, w in zip(got, want):
                    torch.testing.assert_close(g, w, atol=_grad_tol(dtype, w.cpu()),
                                               rtol=TOL[dtype])
    mesh = make_mesh({"sp": 4}, [cuda_device] * 4)
    q, k, v = (torch.randn((2, 256, 2, 32), generator=gen).to(cuda_device, t)
               .requires_grad_() for _ in range(3))
    w = torch.randn((2, 256, 2, 32), generator=gen).to(cuda_device, t)
    got = make_ring_flash_attention(mesh)(q, k, v)
    want = dense_attention(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])
    for g, wg in zip(torch.autograd.grad(got, (q, k, v), w),
                     torch.autograd.grad(want, (q, k, v), w)):
        torch.testing.assert_close(g.float(), wg.float(), atol=_grad_tol(dtype, wg.cpu()),
                                   rtol=TOL[dtype])
