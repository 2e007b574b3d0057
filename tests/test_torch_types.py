"""The port's wire types against the JAX package's, byte for byte, and the
port's import hygiene.

* ``ModelBundle`` bytes are equal in both directions (flax's msgpack
  state-dict encoding, bf16 leaves included).
* Records the port's actor builds serialize to the bytes the JAX types give
  the same records, with the dtypes the JAX actor puts on the wire.
* Importing every module of ``relayrl_tpu_torch`` loads no JAX, no flax, no
  ``relayrl_tpu``, and none of ``msgpack``, ``ml_dtypes`` and ``grpc``
  (which the machines with the GPU need not have); no module, nor
  ``chip_smoke.py``, names the JAX packages in an import statement; and
  no shared library of the port (the native transport library, a CUDA
  kernel library) is built or opened at import.
"""

import ast
import os
import subprocess
import sys

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from relayrl_tpu.models import build_policy as jax_build_policy
from relayrl_tpu.runtime.policy_actor import PolicyActor as JaxPolicyActor
from relayrl_tpu.types import action as jax_action
from relayrl_tpu.types import tensor as jax_tensor
from relayrl_tpu.types import trajectory as jax_trajectory
from relayrl_tpu.types.model_bundle import ModelBundle as JaxModelBundle
from relayrl_tpu_torch.runtime import PolicyActor
from relayrl_tpu_torch.types import ModelBundle, serialize_actions
from relayrl_tpu_torch.types.tensor import decode_tensor, encode_tensor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "optax", "orbax", "relayrl_tpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    this module from crowding the other test workers' CPUs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree():
    rng = np.random.default_rng(0)
    return {"params": {
        "block_0": {"qkv": {"kernel": rng.standard_normal((4, 6)).astype(np.float32),
                            "bias": np.zeros(6, np.float32)}},
        "pos_embed": rng.standard_normal((3, 4)).astype(ml_dtypes.bfloat16),
        "count": np.arange(5, dtype=np.int32),
        "scalar": np.float32(1.5),
        "stack": [np.ones(2, np.float64), np.zeros((1, 1), np.int64)],
    }}


def _assert_tree_equal(a, b):
    fa, fb = (jax.tree_util.tree_flatten_with_path(t)[0] for t in (a, b))
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert x.tobytes() == y.tobytes(), path


def test_bundle_bytes_match_jax_both_ways():
    arch = {"kind": "transformer_discrete", "obs_dim": 4, "act_dim": 2,
            "max_seq_len": 8, "epsilon": 0.1}
    tree = _tree()
    jax_bytes = JaxModelBundle(7, arch, tree).to_bytes()
    assert ModelBundle(7, arch, tree).to_bytes() == jax_bytes
    port = ModelBundle.from_bytes(jax_bytes)
    assert port.version == 7 and port.arch == arch
    assert port.to_bytes() == jax_bytes
    back = JaxModelBundle.from_bytes(port.to_bytes(),
                                     params_template=JaxModelBundle.RAW_TREE)
    _assert_tree_equal(back.params, port.params)

    # a real policy's params, as the JAX package initializes them
    policy = jax_build_policy({**arch, "d_model": 16, "n_layers": 1,
                               "n_heads": 2})
    params = policy.init_params(jax.random.PRNGKey(0))
    assert (ModelBundle(1, arch, params).to_bytes()
            == JaxModelBundle(1, arch, params).to_bytes())


@pytest.mark.parametrize("value", [
    np.arange(6, dtype=np.float32).reshape(2, 3),
    np.array(3, np.int32),
    np.ones((2, 2), ml_dtypes.bfloat16),
    np.zeros((0, 3), np.uint8),
    np.array([True, False]),
])
def test_tensor_frames_match_jax(value):
    frame = encode_tensor(value)
    assert frame == jax_tensor.encode_tensor(value)
    got = decode_tensor(frame)
    assert got.dtype == value.dtype and got.tobytes() == value.tobytes()


def test_actor_records_match_jax_wire():
    arch = {"kind": "transformer_discrete", "obs_dim": 4, "act_dim": 3,
            "d_model": 16, "n_layers": 1, "n_heads": 2, "max_seq_len": 8}
    params = jax.tree.map(np.asarray, jax_build_policy(arch).init_params(
        jax.random.PRNGKey(1)))
    port_actor = PolicyActor(ModelBundle(1, arch, params), device="cpu")
    jax_actor = JaxPolicyActor(JaxModelBundle(1, arch, params),
                               use_kv_cache=False)
    rng = np.random.default_rng(2)
    records, jax_records = [], []
    mask = np.array([1.0, 1.0, 0.0], np.float32)
    for i in range(5):
        obs = rng.standard_normal(4).astype(np.float32)
        records.append(port_actor.request_for_action(obs, mask=mask,
                                                     reward=0.25 * i))
        jax_records.append(jax_actor.request_for_action(obs, mask=mask,
                                                        reward=0.25 * i))
    port_actor.flag_last_action(1.0, truncated=True, final_obs=obs)
    records.append(port_actor.trajectory.get_actions()[-1])

    def layout(rec):
        return [(name, np.asarray(x).dtype, np.asarray(x).shape)
                for name, x in (("obs", rec.obs), ("act", rec.act),
                                ("mask", rec.mask), *sorted(rec.data.items()))]

    for rec, jax_rec in zip(records, jax_records):
        assert layout(rec) == layout(jax_rec)
        assert int(rec.act) != 2  # masked action never drawn
    rebuilt = [jax_action.ActionRecord(
        obs=r.obs, act=r.act, mask=r.mask, rew=r.rew, data=r.data,
        done=r.done, reward_updated=r.reward_updated, truncated=r.truncated)
        for r in records]
    assert serialize_actions(records) == jax_trajectory.serialize_actions(rebuilt)
    for rec, jax_rec in zip(records, rebuilt):
        assert rec.to_bytes() == jax_rec.to_bytes()


def _imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


# The port's shared libraries mapped into the process (every one of them
# lives under build/relayrl_tpu_torch/), and whether the native library
# was built or its codec probed.
_OPENED_LIBRARIES = (
    "import relayrl_tpu_torch._native as nat\n"
    "import relayrl_tpu_torch.types.columnar as col\n"
    "maps = open('/proc/self/maps').read().split('\\n')\n"
    "opened = sorted({l.split()[-1] for l in maps\n"
    "                 if 'relayrl_tpu_torch' in l or 'librelayrl' in l})\n"
    "print('OPENED', opened, 'BUILT', nat._built, 'CODEC', col._codec_checked)\n")


def test_port_imports_no_jax():
    sources = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "relayrl_tpu_torch")):
        sources += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in sources:
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)

    code = (
        "import importlib, pkgutil, sys\n"
        "import relayrl_tpu_torch\n"
        "for m in pkgutil.walk_packages(relayrl_tpu_torch.__path__, 'relayrl_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'relayrl_tpu',\n"
        "              'msgpack', 'ml_dtypes', 'grpc'))\n"
        "print('LOADED', bad)\n"
        + _OPENED_LIBRARIES)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout, out.stdout
    assert "OPENED [] BUILT {} CODEC False" in out.stdout, out.stdout


def test_distributed_loop_imports_clean():
    """The server and agent entry points, the guardrails, the gRPC and
    native backends, the relay, the learners (the off-policy family, its
    Q-networks and step ring included), the CNN, MoE and pipeline model
    families, the pixel pipeline and its example, the on-device envs,
    the anakin tier and the serving plane load no JAX and nothing of
    the JAX package; none of them loads msgpack, ml_dtypes or grpc (the
    transports import them where they encode, decode and connect), and
    none builds or opens a shared library."""
    code = (
        "import sys\n"
        "import relayrl_tpu_torch\n"
        "import relayrl_tpu_torch.runtime.server\n"
        "import relayrl_tpu_torch.runtime.agent\n"
        "import relayrl_tpu_torch.guardrails\n"
        "import relayrl_tpu_torch.transport.grpc_backend\n"
        "import relayrl_tpu_torch.transport.native_backend\n"
        "import relayrl_tpu_torch.transport.native_bindings\n"
        "import relayrl_tpu_torch.relay\n"
        "import relayrl_tpu_torch.algorithms.ppo\n"
        "import relayrl_tpu_torch.algorithms.impala\n"
        "import relayrl_tpu_torch.algorithms.offpolicy\n"
        "import relayrl_tpu_torch.algorithms.dqn\n"
        "import relayrl_tpu_torch.algorithms.c51\n"
        "import relayrl_tpu_torch.algorithms.ddpg\n"
        "import relayrl_tpu_torch.algorithms.td3\n"
        "import relayrl_tpu_torch.algorithms.sac\n"
        "import relayrl_tpu_torch.models.q_networks\n"
        "import relayrl_tpu_torch.models.cnn\n"
        "import relayrl_tpu_torch.models.moe\n"
        "import relayrl_tpu_torch.models.transformer\n"
        "import relayrl_tpu_torch.envs.atari\n"
        "import relayrl_tpu_torch.examples.train_atari\n"
        "import relayrl_tpu_torch.data.step_buffer\n"
        "import relayrl_tpu_torch.envs.device\n"
        "import relayrl_tpu_torch.runtime.anakin\n"
        "import relayrl_tpu_torch.examples.train_distributed\n"
        "import relayrl_tpu_torch.runtime.inference\n"
        "import relayrl_tpu_torch.transport.serving\n"
        "lazy = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "              ('msgpack', 'ml_dtypes', 'grpc'))\n"
        "from relayrl_tpu_torch.runtime import TrainingServer, VectorAgent\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'relayrl_tpu'))\n"
        "print('LAZY', lazy, 'LOADED', bad)\n"
        + _OPENED_LIBRARIES)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LAZY [] LOADED []" in out.stdout, out.stdout
    assert "OPENED [] BUILT {} CODEC False" in out.stdout, out.stdout
