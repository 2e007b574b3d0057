"""One rank of the port's straddled-block tests
(``tests/test_torch_multihost_subgrid.py``).

Each of N processes runs this script against a real ``torch.distributed``
``gloo`` group on the CPU and works through the cases of the case file,
each on its own mesh over the same processes (a case's ``local_devices``
CPU entries a rank), whose process blocks straddle the mesh's lines:

* ``update``: REINFORCE from the case's params (``make_mesh``,
  ``place_state``, ``make_sharded_update`` with the case's
  ``shard_time``) on the coordinator's batch, for two updates; after
  each, the params gathered whole (a collective) and the metrics; after
  the first, what it holds of each parameter (device, shape, Adam
  moments, the axes its squares sum over, its blocks), the collectives
  it met (``distributed.COMM``, ``ring.COMM``) and its data cells;
* ``checkpoint``: ``build_algorithm`` + ``enable_multihost`` over the
  case's mesh, one update, a collective checkpoint, this rank's tensors
  and the bundle; a second update; the restore on every rank and its
  tensors again;
* ``ppo``: PPO through ``build_algorithm`` + ``enable_multihost`` over the
  case's mesh on each of the coordinator's epoch batches: the metrics,
  the params and, for each minibatch, how many of its rows each of this
  rank's data cells holds (what its forward feeds each cell's ring).

Usage: ``_torch_multihost_subgrid_worker.py <rank> <world>
<coordinator_port> <case_file> <out_dir>``; writes ``<out_dir>/rank<r>.pkl``
and prints ``TORCH_MULTIHOST_SUBGRID_OK rank=<r>``.
"""

import os
import pickle
import sys

import torch
from _torch_multihost_pp_worker import _tensors, _zeros_like


def _holdings(state) -> dict:
    """Each parameter leaf of ``state.params`` as this rank holds it: its
    device type, shape, the shape of its Adam moments and the axes its
    squares sum over."""
    moments = {}
    for opt in (state.pi_opt, state.vf_opt):
        for p, st in opt.state.items():
            moments[id(p)] = tuple(st["exp_avg"].shape)
    return {name: {"device": p.device.type, "shape": tuple(p.shape),
                   "moments": moments.get(id(p)),
                   "split_comms": [axis for axis, _ in getattr(p, "split_comms", ())]}
            for name, p in state.params.named_parameters()}


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
        place_batch,
        place_state,
        ring,
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
    placed = place_batch(batch, mesh, case["shard_time"])
    out = {"cross": mesh.cross_axes, "straddles": mesh.straddles, "cells": mesh.cells,
           "accountable": mesh.accountable_cells, "rows": int(placed["valid"].shape[0]),
           "valid_rows": int((placed["valid"].sum(dim=1) > 0).sum()),
           "gathers": gathers_across_processes(state.params), "params": [], "metrics": []}
    for i in range(2):
        distributed.COMM.reset()
        ring.COMM.reset()
        state, metrics = sharded(state, batch)
        comm = {**distributed.COMM.as_dict(),
                **{f"ring_{k}": v for k, v in ring.COMM.as_dict().items()}}
        out["metrics"].append(read_metrics(metrics))
        out["params"].append(params_to_jax(state.params))
        if i == 0:
            out["holdings"] = _holdings(state)
            out["comm"] = comm
    return out


def _checkpoint(case, rank, out_dir):
    from relayrl_tpu_torch.algorithms import build_algorithm
    from relayrl_tpu_torch.checkpoint import checkpoint_algorithm, restore_algorithm
    from relayrl_tpu_torch.parallel import broadcast_from_coordinator, make_mesh
    from relayrl_tpu_torch.weights import gathers_across_processes

    algo = build_algorithm("REINFORCE", env_dir=os.path.join(out_dir, f"ckpt_rank{rank}"),
                           device="cpu", **case["kwargs"])
    algo.enable_multihost(make_mesh(case["mesh"],
                                    [torch.device("cpu")] * case["local_devices"]))
    batches = [broadcast_from_coordinator(b if rank == 0 else _zeros_like(b))
               for b in case["batches"]]
    algo.train_on_batch(batches[0])
    checkpoint_algorithm(algo, case["dir"])
    saved = {"tensors": _tensors(algo), "bundle": algo.bundle().to_bytes()}
    algo.train_on_batch(batches[1])
    moved = _tensors(algo)
    restore_algorithm(algo, case["dir"])
    return {"saved": saved, "moved": moved, "restored": _tensors(algo),
            "version": algo.version, "gathers": gathers_across_processes(algo.state.params)}


def _ppo(case, rank, out_dir):
    from relayrl_tpu_torch.algorithms import build_algorithm, ppo
    from relayrl_tpu_torch.algorithms.onpolicy import read_metrics
    from relayrl_tpu_torch.parallel import broadcast_from_coordinator, make_mesh
    from relayrl_tpu_torch.weights import params_to_jax

    fed = []
    dp_minibatch = ppo.dp_minibatch

    def record(idx, global_rows):
        local, rows = dp_minibatch(idx, global_rows)
        fed.append(rows)
        return local, rows

    ppo.dp_minibatch = record
    try:
        algo = build_algorithm("PPO", env_dir=os.path.join(out_dir, f"ppo_rank{rank}"),
                               device="cpu", **case["kwargs"])
        mesh = make_mesh(case["mesh"], [torch.device("cpu")] * case["local_devices"])
        algo.enable_multihost(mesh)
        metrics = []
        for batch in case["batches"]:
            algo.train_on_batch(broadcast_from_coordinator(
                batch if rank == 0 else _zeros_like(batch)))
            metrics.append(read_metrics(algo._last_metrics))
    finally:
        ppo.dp_minibatch = dp_minibatch
    return {"metrics": metrics, "params": params_to_jax(algo.state.params),
            "version": algo.version, "cells": mesh.cells, "fed": fed}


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
    results = {}
    for name, case in cases.items():
        if case["kind"] == "update":
            results[name] = _update(case, rank)
        elif case["kind"] == "ppo":
            results[name] = _ppo(case, rank, out_dir)
        else:
            results[name] = _checkpoint(case, rank, out_dir)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    distributed.barrier()
    distributed.shutdown_distributed()
    print(f"TORCH_MULTIHOST_SUBGRID_OK rank={rank}", flush=True)


if __name__ == "__main__":
    main()
