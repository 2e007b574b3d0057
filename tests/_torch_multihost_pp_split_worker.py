"""One rank of the port's pipeline-beside-a-split tests
(``tests/test_torch_multihost_pp_split.py``).

Each of N processes runs this script against a real ``torch.distributed``
``gloo`` group on the CPU and works through the cases of the case file,
each on its own mesh over the same processes (a case's ``local_devices``
CPU entries a rank):

* ``update``: REINFORCE on the pipeline transformer from the case's
  params (``make_mesh``, ``place_state``, ``make_sharded_update``, with
  the case's ``shard_time``) on the coordinator's batch, for two updates;
  after each, the params gathered whole (a collective), the metrics and
  this rank's tensors outside the stages (replicated leaves, or its fsdp
  shards) as it holds them; after the first, what it holds of each
  parameter (device, shape, Adam moments, the axes its squares sum over)
  and what the pipeline's hops and the split's gathers and
  reduce-scatters moved;
* ``impala``: ``tests/_torch_multihost_fsdp_worker.py``'s IMPALA case,
  with the squared norms its clip read (``grad_sq_norm``) beside it;
* ``checkpoint``: ``tests/_torch_multihost_pp_worker.py``'s case.

Usage: ``_torch_multihost_pp_split_worker.py <rank> <world>
<coordinator_port> <case_file> <out_dir>``; writes ``<out_dir>/rank<r>.pkl``
and prints ``TORCH_MULTIHOST_PP_SPLIT_OK rank=<r>``.
"""

import os
import pickle
import sys

import torch
from _torch_multihost_fsdp_worker import _impala
from _torch_multihost_pp_worker import _checkpoint, _holdings, _is_stage, _zeros_like


def _update(case, rank):
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
        make_mesh,
        make_sharded_update,
        pipeline,
        place_state,
    )
    from relayrl_tpu_torch.weights import gathers_across_processes, params_to_jax

    hp = case["hp"]
    policy = build_policy(case["arch"], device="cpu")
    params = policy.load_params(case["tree"])
    state = ReinforceState(params, *make_optimizers(params, hp["pi_lr"], hp["vf_lr"]))
    update = make_reinforce_update(policy, hp["vf_iters"], hp["gamma"], hp["lam"], True)
    mesh = make_mesh(case["mesh"], [torch.device("cpu")] * case["local_devices"])
    sharded = make_sharded_update(update, mesh, state, shard_time=case["shard_time"])
    state = place_state(state, mesh)
    batch = broadcast_from_coordinator(case["batch"] if rank == 0
                                       else _zeros_like(case["batch"]))
    out = {"cross": mesh.cross_axes, "stages": mesh.shard_indices("pp"),
           "gathers": gathers_across_processes(state.params),
           "params": [], "metrics": [], "ends": []}
    for i in range(2):
        pipeline.COMM.reset()
        distributed.COMM.reset()
        state, metrics = sharded(state, batch)
        comm = {**pipeline.COMM.as_dict(), **distributed.COMM.as_dict()}
        out["metrics"].append(read_metrics(metrics))
        out["ends"].append({name: p.detach().clone()
                            for name, p in state.params.named_parameters()
                            if not _is_stage(name)})
        out["params"].append(params_to_jax(state.params))
        if i == 0:
            out["holdings"] = _holdings(state)
            out["comm"] = comm
    return out


def _impala_norms(case, rank):
    """:func:`_impala`, with every squared norm its clip read."""
    from relayrl_tpu_torch.algorithms import impala

    norms, read = [], impala.grad_sq_norm

    def recorded(grads, params):
        sq = read(grads, params)
        norms.append(float(sq))
        return sq

    impala.grad_sq_norm = recorded
    try:
        return {**_impala(case, rank), "norms": norms}
    finally:
        impala.grad_sq_norm = read


def main() -> None:
    rank, world, port, case_file, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                             sys.argv[3], sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    from relayrl_tpu_torch.parallel import distributed, initialize_distributed

    info = initialize_distributed(coordinator_address=f"127.0.0.1:{port}",
                                  num_processes=world, process_id=rank)
    assert info == {"multi_host": True, "process_id": rank, "num_processes": world}, info
    with open(case_file, "rb") as f:
        cases = pickle.load(f)
    kinds = {"update": _update, "impala": _impala_norms}
    results = {}
    for name, case in cases.items():
        if case["kind"] == "checkpoint":
            results[name] = _checkpoint(case, rank, out_dir)
        else:
            results[name] = kinds[case["kind"]](case, rank)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    distributed.barrier()
    distributed.shutdown_distributed()
    print(f"TORCH_MULTIHOST_PP_SPLIT_OK rank={rank}", flush=True)


if __name__ == "__main__":
    main()
