"""One rank of the port's two-process ``gloo`` learner test
(``tests/test_torch_multihost.py``).

Each of two processes runs this script against a real ``torch.distributed``
process group on the CPU:

* ``initialize_distributed`` forms the group (gloo: the CPU) and the
  topology and ``is_coordinator`` are checked;
* the coordinator-asymmetric broadcast: rank 0 holds the case file's
  arrays, rank 1 zeros of the same shapes, and every rank must end with
  rank 0's bytes;
* every learner case of the case file: the update over a mesh whose
  ``dp`` axis spans the two processes, each rank on its rows, from the
  case's params and on its batch (rank 0's, broadcast); or a whole
  algorithm (``build_algorithm``, ``enable_multihost``, ``train_on_batch``
  on each broadcast batch).

Usage: ``_torch_multihost_worker.py <rank> <coordinator_port> <case_file>
<out_dir>``. The case file (a pickle the test writes) holds ``broadcast``
(a dict of arrays) and ``cases`` (a list of dicts); the worker writes its
results to ``<out_dir>/rank<r>.pkl`` and prints ``TORCH_MULTIHOST_OK
rank=<r>``.
"""

import os
import pickle
import sys

import numpy as np
import torch


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zeros_like(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    return np.zeros_like(tree)


def _on_policy(case, coordinator: bool):
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
    assert mesh.process_count == 2 and mesh.local.shape["dp"] * 2 == mesh.shape["dp"]
    sharded = make_sharded_update(update, mesh, state)
    state = place_state(state, mesh)
    batch = case["batch"] if coordinator else _zeros_like(case["batch"])
    batch = broadcast_from_coordinator(batch)
    new, metrics = sharded(state, batch)
    return {"params": params_to_jax(new.params), "metrics": read_metrics(metrics),
            "step": new.step}


def state_trees(algo) -> dict:
    """Every network of an algorithm as flax trees, by state field."""
    from relayrl_tpu_torch.weights import params_to_jax

    if hasattr(algo, "state_trees"):
        return algo.state_trees()
    return {"params": params_to_jax(algo.state.params)}


def _algorithm(case, coordinator: bool, workdir: str):
    from relayrl_tpu_torch.algorithms import build_algorithm
    from relayrl_tpu_torch.algorithms.onpolicy import read_metrics
    from relayrl_tpu_torch.parallel import broadcast_from_coordinator, make_mesh

    algo = build_algorithm(case["algo"], env_dir=workdir, device="cpu",
                           **case["kwargs"])
    algo.enable_multihost(make_mesh({"dp": -1}, [torch.device("cpu")]))
    assert algo._warmup_is_collective()
    metrics = []
    for batch in case["batches"]:
        obs = batch["obs"]
        zero = algo.mh_zero_batch(obs.shape[0], obs.shape[1] if obs.ndim == 3 else 0)
        assert {k: (v.shape, v.dtype) for k, v in zero.items()} == {
            k: (v.shape, v.dtype) for k, v in batch.items()}
        batch = broadcast_from_coordinator(batch if coordinator else zero)
        algo.train_on_batch(batch)
        metrics.append(read_metrics(algo._last_metrics))
    return {"trees": state_trees(algo), "metrics": metrics, "version": algo.version}


def main() -> None:
    rank, port, case_file, out_dir = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                      sys.argv[4])
    torch.set_num_threads(1)
    from relayrl_tpu_torch.parallel import (
        broadcast_from_coordinator,
        initialize_distributed,
        is_coordinator,
        process_index,
        shutdown_distributed,
    )
    from relayrl_tpu_torch.parallel import distributed

    info = initialize_distributed(coordinator_address=f"127.0.0.1:{port}",
                                  num_processes=2, process_id=rank)
    assert info == {"multi_host": True, "process_id": rank, "num_processes": 2}, info
    assert is_coordinator() == (rank == 0) and process_index() == rank
    assert distributed.backend() == "gloo", distributed.backend()
    # A repeat call returns the cached topology whatever it is given.
    assert initialize_distributed(num_processes=7) == info

    with open(case_file, "rb") as f:
        spec = pickle.load(f)
    sent = spec["broadcast"]
    got = broadcast_from_coordinator(sent if rank == 0 else _zeros_like(sent))
    results = {"broadcast": got, "cases": []}
    for case in spec["cases"]:
        if case["kind"] == "on_policy":
            results["cases"].append(_on_policy(case, rank == 0))
        else:
            workdir = os.path.join(out_dir, f"{case['algo']}_rank{rank}")
            results["cases"].append(_algorithm(case, rank == 0, workdir))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    distributed.barrier()
    shutdown_distributed()
    print(f"TORCH_MULTIHOST_OK rank={rank}", flush=True)


if __name__ == "__main__":
    main()
