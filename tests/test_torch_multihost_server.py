"""Live agents -> the port's multi-process ``TrainingServer`` on the CPU.

The counterpart of ``tests/test_multihost_server.py``: socket agents feed
the coordinator's ingest while every process of an N-process ``gloo``
learner runs the update in lockstep through the server's broadcast loop
(``tests/_torch_multihost_server_worker.py``). Cells: REINFORCE over ZMQ
(learns a bandit), over the native framed-TCP plane and over gRPC; DQN
(the replay buffer on the coordinator, sampled batches broadcast); SAC
on a continuous bandit; kill and resume (a collective checkpoint, a full
teardown, a resume on every rank, more training); 4 processes; and a
mesh whose fsdp axis spans the ranks (each holds its shards; publishes,
checkpoints and digests gather them).

The 2-process ZMQ cell and the fsdp cell are tier 1; the other cells are
``slow``, as the JAX package marks its own (each is another few-second
multi-process run of the same protocol).
"""

import os
import subprocess
import sys
import time

import pytest

from _util import free_port

_WORKER = os.path.join(os.path.dirname(__file__), "_torch_multihost_server_worker.py")


def _run_cell(tmp_path, mode, n_procs):
    coord = str(free_port())
    ports = [str(free_port()) for _ in range(6)]
    env = dict(os.environ, RELAYRL_NUM_PROCESSES=str(n_procs),
               PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, str(rank), mode, coord, *ports, str(tmp_path)],
        cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for rank in range(n_procs)]
    outs = []
    deadline = time.monotonic() + 420  # one budget for the whole fleet
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        hung = [p.communicate()[0] or "" for p in procs[len(outs):]]
        pytest.fail("multi-process server workers hung:\n" + "\n---\n".join(outs + hung))
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
        assert f"MHSERVER_OK rank={rank}" in out, out[-4000:]
    finals = {line.split("MHSERVER_OK", 1)[1].split(" p1=")[0].split(" ", 2)[2]
              for out in outs for line in out.splitlines() if "MHSERVER_OK" in line}
    # Every rank ends at the same version with the same params.
    assert len(finals) == 1, finals


def test_fleet_trains_two_process_learner_zmq(tmp_path):
    _run_cell(tmp_path, "zmq", 2)


def test_fleet_trains_two_process_fsdp_learner_zmq(tmp_path):
    """The fsdp cell in tier 1: the collective publish and checkpoint of a
    learner whose split parameters span the ranks."""
    _run_cell(tmp_path, "fsdp", 2)


@pytest.mark.slow
@pytest.mark.parametrize("mode,n_procs", [
    ("native", 2),
    ("grpc", 2),
    ("offpolicy", 2),
    ("offpolicy_sac", 2),
    ("resume", 2),
    # The lockstep protocol does not depend on the count of ranks.
    ("zmq", 4),
    ("fsdp", 2),
])
def test_fleet_trains_multiprocess_learner(tmp_path, mode, n_procs):
    _run_cell(tmp_path, mode, n_procs)
