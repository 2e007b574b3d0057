"""One rank of the port's multi-process ``TrainingServer`` tests
(``tests/test_torch_multihost_server.py``).

Each of N processes (``RELAYRL_NUM_PROCESSES``, default 2) builds a port
:class:`TrainingServer` on the CPU over a shared ``gloo`` process group,
its ``dp`` axis one coordinate a process. The coordinator (rank 0) also
runs two socket :class:`Agent` threads on a bandit; their trajectories
reach the coordinator's ingest, every batch is broadcast, and every
process trains on its rows in lockstep.

Modes:

* ``zmq``, ``native``, ``grpc`` — REINFORCE over that transport;
* ``offpolicy`` — DQN: the replay buffer on the coordinator, sampled
  batches broadcast;
* ``offpolicy_sac`` — SAC on a continuous bandit;
* ``resume`` — train and checkpoint collectively, tear the servers down,
  rebuild them with ``resume=True`` (every rank restores the same step),
  train further.

Prints ``MHSERVER_OK rank=<r> version=<v> digest=<sha256> p1=<score>``:
every rank's version and params digest must agree, and rank 0's score
says the published policy learned the bandit.

Usage: ``_torch_multihost_server_worker.py <rank> <mode> <coord_port> <p1>
<p2> <p3> <q1> <q2> <q3> <scratch_dir>`` (q* are the second server's
ports in ``resume``).
"""

import json
import os
import sys
import threading
import time

rank = int(sys.argv[1])
mode = sys.argv[2]
coord_port = sys.argv[3]
ports = sys.argv[4:10]
scratch = sys.argv[10]

os.environ["RELAYRL_COORDINATOR"] = f"127.0.0.1:{coord_port}"
os.environ.setdefault("RELAYRL_NUM_PROCESSES", "2")
NUM_PROCS = int(os.environ["RELAYRL_NUM_PROCESSES"])
os.environ["RELAYRL_PROCESS_ID"] = str(rank)

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from relayrl_tpu_torch.runtime.server import TrainingServer  # noqa: E402

ALGO = {"offpolicy": "DQN", "offpolicy_sac": "SAC"}.get(mode, "REINFORCE")
CONTINUOUS = mode == "offpolicy_sac"
TRANSPORT = mode if mode in ("native", "grpc") else "zmq"
# Multi-process "updates" are broadcast steps: one epoch batch (on-policy)
# or one sampled batch (off-policy) each.
TARGET_UPDATES = {"offpolicy": 60, "offpolicy_sac": 300,
                  "resume": 12}.get(mode, 30)

# A config copy per rank (same content; no write race on a shared file).
# The checkpoint directory is shared, as a multi-host deployment's is.
cfg_path = os.path.join(scratch, f"relayrl_config_rank{rank}.json")
with open(cfg_path, "w") as f:
    json.dump({"learner": {"checkpoint_every_epochs": 5,
                           "checkpoint_dir": os.path.join(scratch, "checkpoints")}},
              f)
env_dir = os.path.join(scratch, f"rank{rank}")
os.makedirs(env_dir, exist_ok=True)

HYPERPARAMS = {
    "REINFORCE": {"traj_per_epoch": 8, "hidden_sizes": [16], "seed": 3,
                  "with_vf_baseline": True, "pi_lr": 0.005,
                  "train_vf_iters": 3},
    "DQN": {"traj_per_epoch": 8, "hidden_sizes": [16], "seed": 3,
            "update_after": 64, "batch_size": 32, "lr": 2e-3,
            "epsilon_decay_steps": 100, "epsilon_end": 0.05},
    # Continuous bandit, reward 1 - (a - 0.5)^2: a non-discrete sampled
    # batch through the broadcast and continuous actions on the wire.
    "SAC": {"traj_per_epoch": 8, "hidden_sizes": [16], "seed": 3,
            "update_after": 32, "batch_size": 128,
            "updates_per_step": 4.0, "max_updates_per_ingest": 16,
            "discrete": False, "act_limit": 1.0},
}[ALGO]
if ALGO == "REINFORCE" and NUM_PROCS > 2:
    # The epoch's rows split over dp = NUM_PROCS.
    HYPERPARAMS["traj_per_epoch"] = 4 * NUM_PROCS


def server_addr_overrides(phase_ports):
    p1, p2, p3 = phase_ports
    if TRANSPORT in ("native", "grpc"):
        return {"bind_addr": f"127.0.0.1:{p1}"}
    return {"agent_listener_addr": f"tcp://127.0.0.1:{p1}",
            "trajectory_addr": f"tcp://127.0.0.1:{p2}",
            "model_pub_addr": f"tcp://127.0.0.1:{p3}"}


def agent_addr_overrides(phase_ports):
    p1, p2, p3 = phase_ports
    if TRANSPORT in ("native", "grpc"):
        return {"server_addr": f"127.0.0.1:{p1}"}
    return {"agent_listener_addr": f"tcp://127.0.0.1:{p1}",
            "trajectory_addr": f"tcp://127.0.0.1:{p2}",
            "model_sub_addr": f"tcp://127.0.0.1:{p3}"}


def build_server(phase_ports, resume, start=True):
    return TrainingServer(
        ALGO, obs_dim=3, act_dim=1 if CONTINUOUS else 2, env_dir=env_dir,
        server_type=TRANSPORT, config_path=cfg_path, hyperparams=HYPERPARAMS,
        resume=resume, start=start, device="cpu",
        **server_addr_overrides(phase_ports))


class _BanditEnv:
    """Two-armed bandit (action 1 pays 1.0) or, continuous, a reward of
    1 - (a - 0.5)^2."""

    def __init__(self, obs_dim=3, horizon=4):
        self.obs = np.zeros(obs_dim, np.float32)
        self.horizon = horizon
        self._t = 0

    def reset(self, seed=None):
        self._t = 0
        return self.obs, {}

    def step(self, action):
        self._t += 1
        a = float(np.asarray(action).reshape(-1)[0])
        rew = 1.0 - (a - 0.5) ** 2 if CONTINUOUS else float(int(a) == 1)
        return self.obs, rew, self._t >= self.horizon, False, {}


def drive_fleet(server, phase_ports, target_updates, tag):
    """Rank 0: two socket agents play until the server has trained
    ``target_updates`` times; returns the published policy's score (p(arm
    1), or SAC's mode's reward) from the bytes agents receive."""
    from relayrl_tpu_torch.models import build_policy
    from relayrl_tpu_torch.runtime.agent import Agent, run_gym_loop
    from relayrl_tpu_torch.types.model_bundle import ModelBundle

    stop_actors = threading.Event()

    def actor(seed):
        agent = Agent(server_type=TRANSPORT, handshake_timeout_s=60, seed=seed,
                      config_path=cfg_path, device="cpu",
                      model_path=os.path.join(scratch, f"client_{tag}_{seed}.bin"),
                      **agent_addr_overrides(phase_ports))
        env = _BanditEnv()
        while not stop_actors.is_set():
            run_gym_loop(agent, env, episodes=2, max_steps=8)
            time.sleep(0.01)
        agent.disable_agent()

    actors = [threading.Thread(target=actor, args=(s,), daemon=True)
              for s in (11, 12)]
    for t in actors:
        t.start()
    deadline = time.time() + 180
    while server.stats["updates"] < target_updates and time.time() < deadline:
        time.sleep(0.2)
    stop_actors.set()
    for t in actors:
        t.join(timeout=30)
        assert not t.is_alive(), "an agent thread did not stop"
    assert server.stats["updates"] >= target_updates, server.stats
    assert server.stats["dropped"] == 0 and server.stats["learner_errors"] == 0, \
        server.stats

    bundle = ModelBundle.from_bytes(server._get_model()[1])
    policy = build_policy(bundle.arch, "cpu")
    params = policy.load_params(bundle.params)
    obs = torch.zeros(3)
    mask = torch.ones(1 if CONTINUOUS else 2)
    with torch.no_grad():
        if CONTINUOUS:
            # SAC's entropy target keeps the sampled policy wide on a
            # bandit; its mode starts at tanh(0) = 0 and moves toward 0.5.
            m = float(policy.mode(params, obs, mask).reshape(-1)[0])
            assert m >= 0.05, f"policy mode never moved toward 0.5: {m}"
            return 1.0 - (m - 0.5) ** 2
        gen = torch.Generator().manual_seed(0)
        acts = [int(policy.step(params, gen, obs, mask)[0].reshape(-1)[0])
                for _ in range(200)]
    return sum(a == 1 for a in acts) / len(acts)


def wait_for_stop(server):
    """Non-coordinator: the learner thread steps on every broadcast until
    the coordinator's STOP; never give up early (leaving while rank 0 is
    mid-collective would hang it)."""
    server._learner_thread.join(timeout=420)
    assert not server._learner_thread.is_alive(), "rank never saw STOP"


def digest(server):
    from relayrl_tpu_torch.checkpoint.manager import capture_state, train_state_digest

    return train_state_digest(capture_state(server.algorithm.state))["params"]


def agree(server):
    """Every rank's version and params digest, gathered through the
    coordinator broadcast: each rank checks rank 0's against its own."""
    from relayrl_tpu_torch.parallel import broadcast_from_coordinator

    mine = np.frombuffer(f"{server.algorithm.version:08d}{digest(server)}".encode(),
                         np.uint8).copy()
    theirs = broadcast_from_coordinator(mine)
    assert np.array_equal(mine, theirs), (mine.tobytes(), theirs.tobytes())
    return server.algorithm.version


def run_phase(server, phase_ports, target, tag):
    assert server.distributed_info == {"multi_host": True, "process_id": rank,
                                       "num_processes": NUM_PROCS}
    assert (server.transport is not None) == (rank == 0)
    assert server._mh_mesh.shape["dp"] == NUM_PROCS
    score = -1.0
    if rank == 0:
        score = drive_fleet(server, phase_ports, target, tag)
        server.disable_server()  # broadcasts STOP, releasing the others
    else:
        wait_for_stop(server)
        server.disable_server()
    return score


server = build_server(ports[:3], resume=False)
p1 = run_phase(server, ports[:3], TARGET_UPDATES, "a")
version = agree(server)
assert version >= TARGET_UPDATES
if rank == 0 and mode != "resume":
    assert p1 >= 0.7, f"policy did not learn the bandit: score {p1}"

if mode == "resume":
    ckpt_dir = os.path.join(scratch, "checkpoints")
    assert os.path.isdir(ckpt_dir), "no collective checkpoint written"
    # start=False: agree() is a collective on this thread, which must not
    # race the learner thread's descriptor broadcasts.
    server2 = build_server(ports[3:6], resume=True, start=False)
    restored = agree(server2)
    assert 0 < restored <= version and restored % 5 == 0, (restored, version)
    server2.enable_server()
    p1 = run_phase(server2, ports[3:6], 5, "b")
    final = agree(server2)
    assert final >= restored + 5, (restored, final)
    version = final
    server = server2

print(f"MHSERVER_OK rank={rank} version={version} digest={digest(server)} "
      f"p1={p1:.2f}", flush=True)
