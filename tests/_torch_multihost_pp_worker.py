"""One rank of the port's cross-process pipeline tests
(``tests/test_torch_multihost_pp.py``).

Each of N processes runs this script against a real ``torch.distributed``
``gloo`` group on the CPU and works through the cases of the case file:

* ``update``: REINFORCE on the pipeline transformer from the case's
  params over a mesh whose pp axis spans the processes (``make_mesh``,
  ``place_state``, ``make_sharded_update``), on the coordinator's batch
  (broadcast), for two updates; after each, the params gathered whole (a
  collective), the metrics and this rank's replicated leaves (every
  parameter outside a stage) as it holds them; after the first, what this
  rank holds of each layer (its parameters' devices, their Adam moments)
  and what the pipeline's hops moved (the case's ``hp`` may freeze
  leaves, ``learner.freeze``'s patterns);
* ``impala``: IMPALA on the pipeline transformer from the case's params
  with a ``max_grad_norm`` whose clip engages, for two updates
  (``tests/_torch_multihost_fsdp_worker.py``'s case); the params gathered
  whole and the metrics after each;
* ``checkpoint``: ``build_algorithm`` + ``enable_multihost`` over the
  case's mesh, one update, a collective checkpoint, this rank's tensors
  (its stages' and the replicated ends' parameters and moments) and the
  bundle; a second update; the restore on every rank and its tensors
  again.

Usage: ``_torch_multihost_pp_worker.py <rank> <world> <coordinator_port>
<case_file> <out_dir>``; writes ``<out_dir>/rank<r>.pkl`` and prints
``TORCH_MULTIHOST_PP_OK rank=<r>``.
"""

import os
import pickle
import sys

import numpy as np
import torch
from _torch_multihost_fsdp_worker import _impala


def _zeros_like(batch):
    return {k: np.zeros_like(v) for k, v in batch.items()}


def _is_stage(name: str) -> bool:
    return name.startswith("blocks.")


def _holdings(state) -> dict:
    """Each parameter of ``state.params`` as this rank holds it: its
    device type and whether an optimizer of the state holds Adam moments
    for it (of its shape)."""
    moments = {}
    for opt in (state.pi_opt, state.vf_opt):
        for p, st in opt.state.items():
            moments[id(p)] = tuple(st["exp_avg"].shape)
    return {name: {"device": p.device.type, "shape": tuple(p.shape),
                   "moments": moments.get(id(p)),
                   "split_comms": [axis for axis, _ in getattr(p, "split_comms", ())]}
            for name, p in state.params.named_parameters()}


def _replicated(module) -> dict:
    """The parameters outside the pipeline's stages, as this rank holds
    them."""
    return {name: p.detach().clone() for name, p in module.named_parameters()
            if not _is_stage(name)}


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
        make_mesh,
        make_sharded_update,
        pipeline,
        place_state,
    )
    from relayrl_tpu_torch.weights import gathers_across_processes, params_to_jax

    hp = case["hp"]
    policy = build_policy(case["arch"], device="cpu")
    params = policy.load_params(case["tree"])
    state = ReinforceState(params, *make_optimizers(params, hp["pi_lr"], hp["vf_lr"],
                                                    hp.get("freeze", ())))
    update = make_reinforce_update(policy, hp["vf_iters"], hp["gamma"], hp["lam"], True)
    mesh = make_mesh(case["mesh"], [torch.device("cpu")] * case["local_devices"])
    sharded = make_sharded_update(update, mesh, state)
    state = place_state(state, mesh)
    batch = broadcast_from_coordinator(case["batch"] if rank == 0
                                       else _zeros_like(case["batch"]))
    out = {"cross": mesh.cross_axes, "stages": mesh.shard_indices("pp"),
           "gathers": gathers_across_processes(state.params),
           "params": [], "metrics": [], "replicated": []}
    for i in range(2):
        pipeline.COMM.reset()
        state, metrics = sharded(state, batch)
        comm = pipeline.COMM.as_dict()
        out["metrics"].append(read_metrics(metrics))
        out["replicated"].append(_replicated(state.params))
        out["params"].append(params_to_jax(state.params))
        if i == 0:
            out["holdings"] = _holdings(state)
            out["comm"] = comm
    return out


def _tensors(algo) -> dict:
    """This rank's parameter tensors (another rank's stage is absent) and
    their moments, by name."""
    out = {name: p.detach().clone() for name, p in algo.state.params.named_parameters()
           if not p.is_meta}
    for field, opt in vars(algo.state).items():
        if not isinstance(opt, torch.optim.Optimizer):
            continue
        params = [p for group in opt.param_groups for p in group["params"]]
        for i, p in enumerate(params):
            for key, value in opt.state.get(p, {}).items():
                out[f"{field}.{i}.{key}"] = value.detach().clone()
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
    assert gathers_across_processes(algo.state.params)
    batches = [broadcast_from_coordinator(b if rank == 0 else _zeros_like(b))
               for b in case["batches"]]
    algo.train_on_batch(batches[0])
    checkpoint_algorithm(algo, case["dir"])
    saved = {"tensors": _tensors(algo), "bundle": algo.bundle().to_bytes()}
    algo.train_on_batch(batches[1])
    moved = _tensors(algo)
    restore_algorithm(algo, case["dir"])
    return {"saved": saved, "moved": moved, "restored": _tensors(algo),
            "version": algo.version}


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
        elif case["kind"] == "impala":
            results[name] = _impala(case, rank)
        else:
            results[name] = _checkpoint(case, rank, out_dir)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    distributed.barrier()
    distributed.shutdown_distributed()
    print(f"TORCH_MULTIHOST_PP_OK rank={rank}", flush=True)


if __name__ == "__main__":
    main()
