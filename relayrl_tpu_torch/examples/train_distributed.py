"""The full distributed loop on the port: TrainingServer + N actor processes.

Twin of ``examples/train_distributed.py`` (REINFORCE over ZMQ or gRPC),
plus ``--device``: the server and every actor run on the GPU unless ``--device
cpu``. Actors are OS processes started with the ``spawn`` context (never a
fork after CUDA is up), each with its own policy copy, streaming
trajectories to the one server and hot-swapping on every publish::

    python -m relayrl_tpu_torch.examples.train_distributed --algo REINFORCE \
        --baseline --env cartpole --transport zmq --device cuda \
        --episodes 3000 --target 475

``--target`` stops an actor once the rolling 50-episode average of its
returns reaches the bar; the driver then prints the update (model version)
at which each actor crossed it and the env steps per second. The server
runs the reference's default config, training-health guardrails on
(ingest validation, quarantine, the divergence watchdog and rollback);
``--no-guardrails`` writes ``guardrails.enabled: false`` into the run's
config. The config and the logs live in ``--run-dir`` (default: a fresh
temporary directory).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import socket
import tempfile
import time

_ENV_IDS = {"cartpole": "CartPole-v1",
            "pendulum": "Pendulum-v1",
            "lunarlander": "LunarLander-v3"}
_ENV_DIMS = {"cartpole": (4, 2), "pendulum": (3, 1), "lunarlander": (8, 4)}
_WINDOW = 50  # episodes in the rolling average --target reads


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def actor_proc(idx: int, server_type: str, agent_addrs: dict, env_id: str,
               episodes: int, max_steps: int, target, config_path: str,
               device, queue) -> None:
    import torch

    from relayrl_tpu_torch.envs import make
    from relayrl_tpu_torch.runtime.agent import Agent, run_gym_loop

    if device == "cpu":
        # Actors are one-core hosts (the JAX example pins them to a core):
        # N actor processes with a full intra-op pool each oversubscribe
        # the host the learner shares.
        torch.set_num_threads(1)
    agent = Agent(server_type=server_type, seed=idx, config_path=config_path,
                  device=device, model_path=os.path.join(
                      os.path.dirname(config_path), f"client_model_{idx}.rlx"),
                  **agent_addrs)
    env = make(env_id)
    returns, solved_at = [], None
    t0 = time.time()
    for ep in range(episodes):
        ret = run_gym_loop(agent, env, episodes=1, max_steps=max_steps,
                           seed=None)[0]
        returns.append(ret)
        if (target is not None and len(returns) >= _WINDOW
                and sum(returns[-_WINDOW:]) / _WINDOW >= target):
            solved_at = {"episode": ep + 1, "version": agent.model_version}
            break
    train_s = time.time() - t0
    queue.put((idx, returns, agent.model_version, solved_at, train_s,
               int(agent.actor.steps_served)))
    agent.disable_agent()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--algo", default="REINFORCE",
                    help="any registered algorithm (the port has REINFORCE)")
    ap.add_argument("--env", default="cartpole", choices=sorted(_ENV_IDS))
    ap.add_argument("--transport", default="zmq",
                    choices=["zmq", "grpc", "native"],
                    help="the port speaks zmq and grpc; native raises "
                         "NotImplementedError")
    ap.add_argument("--actors", type=int, default=1)
    ap.add_argument("--episodes", type=int, default=200,
                    help="episodes PER actor")
    ap.add_argument("--max-steps", type=int, default=500)
    ap.add_argument("--baseline", action="store_true")
    ap.add_argument("--target", type=float, default=None,
                    help="stop an actor once its rolling "
                         f"{_WINDOW}-episode average return reaches this")
    ap.add_argument("--hp", action="append", default=[], metavar="K=V",
                    help="extra algorithm hyperparameter (repeatable); "
                         "values parse as JSON when possible")
    ap.add_argument("--device", default=None,
                    help="torch device for the server and the actors "
                         "(default: the GPU)")
    ap.add_argument("--no-guardrails", action="store_true",
                    help="turn the server's training-health guardrails "
                         "off (the default config has them on)")
    ap.add_argument("--run-dir", default=None,
                    help="config, logs and checkpoints (default: a fresh "
                         "temporary directory)")
    args = ap.parse_args(argv)

    from relayrl_tpu_torch.runtime.server import TrainingServer

    run_dir = args.run_dir or tempfile.mkdtemp(prefix="relayrl_distributed_")
    os.makedirs(run_dir, exist_ok=True)
    config_path = os.path.join(run_dir, "relayrl_config.json")
    with open(config_path, "w") as f:
        json.dump({"guardrails": {"enabled": False}}
                  if args.no_guardrails else {}, f)

    if args.transport == "grpc":
        server_addrs = {"bind_addr": f"127.0.0.1:{free_port()}"}
        agent_addrs = {"server_addr": server_addrs["bind_addr"]}
    else:
        server_addrs = {
            "agent_listener_addr": f"tcp://127.0.0.1:{free_port()}",
            "trajectory_addr": f"tcp://127.0.0.1:{free_port()}",
            "model_pub_addr": f"tcp://127.0.0.1:{free_port()}",
        }
        agent_addrs = {
            "agent_listener_addr": server_addrs["agent_listener_addr"],
            "trajectory_addr": server_addrs["trajectory_addr"],
            "model_sub_addr": server_addrs["model_pub_addr"],
        }
    hp: dict = {}
    if args.algo.upper() == "REINFORCE":
        hp["with_vf_baseline"] = args.baseline
    if args.env == "pendulum":
        hp["discrete"] = False
        hp["act_limit"] = 2.0
    for kv in args.hp:
        key, sep, raw = kv.partition("=")
        if not sep:
            raise SystemExit(f"--hp expects K=V, got {kv!r}")
        try:
            hp[key] = json.loads(raw)
        except ValueError:
            hp[key] = raw
    obs_dim, act_dim = _ENV_DIMS[args.env]

    server = TrainingServer(
        args.algo, obs_dim=obs_dim, act_dim=act_dim,
        server_type=args.transport, env_dir=run_dir,
        config_path=config_path, hyperparams=hp, device=args.device,
        **server_addrs)
    print(f"[driver] server on {server.device}, run dir {run_dir}",
          flush=True)

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=actor_proc,
                         args=(i, args.transport, agent_addrs,
                               _ENV_IDS[args.env], args.episodes,
                               args.max_steps, args.target, config_path,
                               args.device, queue))
             for i in range(args.actors)]
    for p in procs:
        p.start()
    # An actor that dies before reporting must fail the driver, not wedge
    # it on a queue.get that will never be fed.
    results = []
    while len(results) < len(procs):
        try:
            results.append(queue.get(timeout=1.0))
        except Exception:
            reported = {r[0] for r in results}
            dead = [(i, p.exitcode) for i, p in enumerate(procs)
                    if p.exitcode is not None and i not in reported]
            if dead and len(results) + len(dead) >= len(procs):
                server.disable_server()
                raise SystemExit(
                    f"actor(s) {dead} ((idx, exitcode)) exited before "
                    f"reporting — see the traceback above")
    for p in procs:
        p.join()
    server.drain()
    elapsed = max(r[4] for r in results)
    steps = sum(r[5] for r in results)
    total_eps = sum(len(r[1]) for r in results)
    for idx, returns, version, solved_at, train_s, n_steps in sorted(results):
        tail = returns[-_WINDOW:]
        print(f"[distributed] actor {idx}: {len(returns)} episodes, "
              f"{n_steps} env steps in {train_s:.1f} s, rolling "
              f"{len(tail)}-episode average {sum(tail) / len(tail):.1f}, "
              f"model version {version}, "
              + (f"reached {args.target} at episode {solved_at['episode']} "
                 f"(update {solved_at['version']})" if solved_at else
                 "target not reached" if args.target is not None else
                 "no target"), flush=True)
    print(f"\n[distributed] {args.actors} actor(s): {total_eps} episodes, "
          f"{steps} env steps in {elapsed:.1f} s ({steps / elapsed:.1f} env "
          f"steps/s); server version {server.algorithm.version}, "
          f"stats {server.stats}", flush=True)
    server.disable_server()
    return results


if __name__ == "__main__":
    main()
