"""One rank of the port's cross-process fsdp, ep and tp tests
(``tests/test_torch_multihost_fsdp.py``).

Each of N processes runs this script against a real ``torch.distributed``
``gloo`` group on the CPU and works through the cases of the case file:

* ``update``: REINFORCE from the case's params over a mesh whose fsdp, ep
  or tp axis spans the processes (``make_mesh``, ``place_state``,
  ``make_sharded_update``), on the coordinator's batch (broadcast), for
  two updates; after each, the params gathered whole (a collective) and
  the metrics; after the first, what this rank holds of every split
  parameter (its shards' coordinates, devices and shapes, their Adam
  moments' shapes);
* ``impala``: IMPALA from the case's params under the case's mesh, with
  a ``max_grad_norm`` small enough that the global-norm clip engages, for
  two updates; the params gathered whole and the metrics after each;
* ``checkpoint``: ``build_algorithm`` + ``enable_multihost`` over
  ``{"dp": 1, "fsdp": 2}``, one update, a collective checkpoint, this
  rank's shards and the bundle; a second update; the restore on every
  rank and its shards again.

Usage: ``_torch_multihost_fsdp_worker.py <rank> <world> <coordinator_port>
<case_file> <out_dir>``; writes ``<out_dir>/rank<r>.pkl`` and prints
``TORCH_MULTIHOST_FSDP_OK rank=<r>``.
"""

import os
import pickle
import sys

import numpy as np
import torch


def _zeros_like(batch):
    return {k: np.zeros_like(v) for k, v in batch.items()}


def _holdings(state) -> dict:
    """Every split parameter of ``state.params`` as this rank holds it."""
    from relayrl_tpu_torch.parallel.sharding import placement, shard_tensors

    moments = {}
    for opt in (state.pi_opt, state.vf_opt):
        for p, st in opt.state.items():
            moments[id(p)] = tuple(st["exp_avg"].shape)
    out = {}
    for name, module in state.params.named_modules():
        for leaf in list(getattr(module, "parametrizations", None) or {}):
            spec = placement(module, leaf)
            tensors = shard_tensors(module, leaf)
            out[f"{name}.{leaf}"] = {
                "spec": spec.spec, "shape": spec.shape, "parts": spec.parts,
                "local": spec.local, "crosses": spec.crosses, "coords": spec.coords,
                "devices": [str(t.device) for t in tensors],
                "leaf": [t.is_leaf for t in tensors],
                "shards": [tuple(t.shape) for t in tensors],
                "moments": [moments.get(id(t)) for t in tensors],
                "summed_over_fsdp": [getattr(t, "summed_over_fsdp", False)
                                     for t in tensors]}
    return out


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
        place_state,
    )
    from relayrl_tpu_torch.weights import params_to_jax

    hp = case["hp"]
    policy = build_policy(case["arch"], device="cpu")
    params = policy.load_params(case["tree"])
    state = ReinforceState(params, *make_optimizers(params, hp["pi_lr"], hp["vf_lr"]))
    update = make_reinforce_update(policy, hp["vf_iters"], hp["gamma"], hp["lam"], True)
    mesh = make_mesh(case["mesh"], [torch.device("cpu")] * case["local_devices"])
    sharded = make_sharded_update(update, mesh, state)
    state = place_state(state, mesh)
    batch = broadcast_from_coordinator(case["batch"] if rank == 0
                                       else _zeros_like(case["batch"]))
    out = {"cross": mesh.cross_axes, "params": [], "metrics": []}
    for i in range(2):
        state, metrics = sharded(state, batch)
        out["metrics"].append(read_metrics(metrics))
        out["params"].append(params_to_jax(state.params))
        if i == 0:
            out["holdings"] = _holdings(state)
    return out


def _impala(case, rank):
    from relayrl_tpu_torch.algorithms.impala import (
        ImpalaState,
        make_impala_optimizer,
        make_impala_update,
    )
    from relayrl_tpu_torch.algorithms.onpolicy import read_metrics
    from relayrl_tpu_torch.models import build_policy
    from relayrl_tpu_torch.parallel import (
        broadcast_from_coordinator,
        make_mesh,
        make_sharded_update,
        place_state,
    )
    from relayrl_tpu_torch.weights import params_to_jax

    hp = case["hp"]
    policy = build_policy(case["arch"], device="cpu")
    params = policy.load_params(case["tree"])
    state = ImpalaState(params, make_impala_optimizer(params, hp["lr"]))
    update = make_impala_update(policy, hp["gamma"], hp["vf_coef"], hp["ent_coef"],
                                hp["rho_bar"], hp["c_bar"], hp["max_grad_norm"])
    mesh = make_mesh(case["mesh"], [torch.device("cpu")] * case["local_devices"])
    sharded = make_sharded_update(update, mesh, state)
    state = place_state(state, mesh)
    batch = broadcast_from_coordinator(case["batch"] if rank == 0
                                       else _zeros_like(case["batch"]))
    out = {"cross": mesh.cross_axes, "params": [], "metrics": []}
    for _ in range(2):
        state, metrics = sharded(state, batch)
        out["metrics"].append(read_metrics(metrics))
        out["params"].append(params_to_jax(state.params))
    return out


def _shards(algo) -> dict:
    """This rank's shard tensors and their moments, by name."""
    out = {name: p.detach().clone() for name, p in algo.state.params.named_parameters()}
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
    algo.enable_multihost(make_mesh(case["mesh"], [torch.device("cpu")]))
    assert gathers_across_processes(algo.state.params)
    batches = [broadcast_from_coordinator(b if rank == 0 else _zeros_like(b))
               for b in case["batches"]]
    algo.train_on_batch(batches[0])
    checkpoint_algorithm(algo, case["dir"])
    saved = {"shards": _shards(algo), "bundle": algo.bundle().to_bytes()}
    algo.train_on_batch(batches[1])
    moved = _shards(algo)
    restore_algorithm(algo, case["dir"])
    return {"saved": saved, "moved": moved, "restored": _shards(algo),
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
    print(f"TORCH_MULTIHOST_FSDP_OK rank={rank}", flush=True)


if __name__ == "__main__":
    main()
