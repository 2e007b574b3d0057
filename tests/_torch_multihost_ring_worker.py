"""One rank of the port's two-process sequence-parallel ring test
(``tests/test_torch_multihost_ring.py``).

Each of two processes runs this script against a real ``torch.distributed``
process group on the CPU (gloo), with 4 CPU devices each, and trains the
reference worker's ring transformer (``tests/_multihost_worker.py``) over
``{"dp": 1, "sp": 8}``: shards 0-3 on rank 0, 4-7 on rank 1, the K/V
chunks hopping between the processes. Rank 1 starts from zeros and takes
the coordinator's batch from the broadcast.

Usage: ``_torch_multihost_ring_worker.py <rank> <coordinator_port>
<case_file> <out_dir>``. The case file (a pickle the test writes) holds
``arch``, ``tree`` (flax params), ``hp`` and ``batch``; the worker writes
``<out_dir>/rank<r>.pkl`` and prints ``TORCH_MULTIHOST_RING_OK rank=<r>``.
"""

import os
import pickle
import sys

import numpy as np
import torch


def main() -> None:
    rank, port, case_file, out_dir = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                      sys.argv[4])
    torch.set_num_threads(1)
    from relayrl_tpu_torch.algorithms.onpolicy import read_metrics
    from relayrl_tpu_torch.algorithms.reinforce import (
        ReinforceState,
        make_optimizers,
        make_reinforce_update,
    )
    from relayrl_tpu_torch.models import build_policy
    from relayrl_tpu_torch.parallel import (
        broadcast_from_coordinator,
        distributed,
        initialize_distributed,
        make_mesh,
        make_sharded_update,
        place_state,
    )
    from relayrl_tpu_torch.parallel import ring, ring_flash
    from relayrl_tpu_torch.weights import params_to_jax

    info = initialize_distributed(coordinator_address=f"127.0.0.1:{port}",
                                  num_processes=2, process_id=rank)
    assert info == {"multi_host": True, "process_id": rank, "num_processes": 2}, info
    assert distributed.backend() == "gloo", distributed.backend()
    with open(case_file, "rb") as f:
        case = pickle.load(f)
    hp = case["hp"]

    mesh = make_mesh({"dp": 1, "sp": 8}, [torch.device("cpu")] * 4)
    assert mesh.cross_axes == ("sp",), mesh.cross_axes
    assert mesh.shard_indices("sp") == list(range(4 * rank, 4 * rank + 4))
    assert mesh.axis_ranks("sp") == (0, 1) and mesh.axis_ranks("dp") == (rank,)
    assert distributed.data_parallel_group(mesh) is None

    policy = build_policy(case["arch"], device="cpu")
    params = policy.load_params(case["tree"])
    state = ReinforceState(params, *make_optimizers(params, hp["pi_lr"], hp["vf_lr"]))
    update = make_reinforce_update(policy, hp["vf_iters"], hp["gamma"], hp["lam"], True)
    sharded = make_sharded_update(update, mesh, state, shard_time=True)
    state = place_state(state, mesh)

    sent = case["batch"]
    batch = broadcast_from_coordinator(
        sent if rank == 0 else {k: np.zeros_like(v) for k, v in sent.items()})
    calls = {"fwd": 0, "dq": 0, "dkv": 0}
    plain = (ring_flash.chunk_fwd_plain, ring_flash.chunk_dq_plain,
             ring_flash.chunk_dkv_plain)

    def counted(name, fn):
        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call

    ring_flash.chunk_fwd_plain, ring_flash.chunk_dq_plain, ring_flash.chunk_dkv_plain = (
        counted("fwd", plain[0]), counted("dq", plain[1]), counted("dkv", plain[2]))
    ring.COMM.reset()
    try:
        new, metrics = sharded(state, batch)
    finally:
        (ring_flash.chunk_fwd_plain, ring_flash.chunk_dq_plain,
         ring_flash.chunk_dkv_plain) = plain
    out = {"batch": batch, "params": params_to_jax(new.params),
           "metrics": read_metrics(metrics), "step": int(new.step), "calls": calls,
           "hops": ring.COMM.hops, "hop_bytes": ring.COMM.hop_bytes,
           "gathers": ring.COMM.gathers}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    distributed.barrier()
    distributed.shutdown_distributed()
    print(f"TORCH_MULTIHOST_RING_OK rank={rank}", flush=True)


if __name__ == "__main__":
    main()
