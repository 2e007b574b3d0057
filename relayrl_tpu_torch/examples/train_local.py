"""Minimum end-to-end slice on the port: in-process actor + learner, no sockets.

Twin of ``examples/train_local.py``, with the same flags and
hyperparameters (``--algo`` REINFORCE, PPO, IMPALA, DQN or C51 on
CartPole; DDPG, TD3 or SAC on Pendulum); it runs on the GPU (``--device
cpu`` runs it on the CPU)::

    python -m relayrl_tpu_torch.examples.train_local --algo REINFORCE \
        --env cartpole --baseline --updates 400 --target 480
    python -m relayrl_tpu_torch.examples.train_local --algo DQN \
        --env cartpole --updates 3000 --target 150
    python -m relayrl_tpu_torch.examples.train_local --algo SAC \
        --env pendulum --updates 200 --target -250

An update is an ingest that trained: for the off-policy family, one
episode past ``update_after``, with ``updates_per_step`` gradient updates
per stored step.

Prints the rolling average return every 5 updates, then the wall time,
the env steps per second and a greedy evaluation.
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--algo", default="REINFORCE",
                    help="any registered algorithm (REINFORCE/PPO/IMPALA/"
                         "DQN/C51 for cartpole; DDPG/TD3/SAC for pendulum)")
    ap.add_argument("--env", default="cartpole",
                    choices=["cartpole", "pendulum", "lunarlander"])
    ap.add_argument("--baseline", action="store_true",
                    help="REINFORCE: add the value baseline")
    ap.add_argument("--updates", type=int, default=40)
    ap.add_argument("--target", type=float, default=None,
                    help="stop early once the rolling avg return passes this")
    ap.add_argument("--continuous", action="store_true",
                    help="lunarlander only: the continuous-action variant "
                         "(needs Gymnasium Box2D)")
    ap.add_argument("--hp", action="append", default=[], metavar="K=V",
                    help="algorithm hyperparameter overrides, e.g. "
                         "--hp gamma=0.999; values parse as JSON with string "
                         "fallback")
    ap.add_argument("--eval-episodes", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    import torch

    from relayrl_tpu_torch.envs import make
    from relayrl_tpu_torch.runtime.local_runner import LocalRunner

    if args.continuous and args.env != "lunarlander":
        ap.error("--continuous only applies to --env lunarlander")
    hp = {}
    env_kwargs = {}
    if args.algo.upper() == "REINFORCE":
        hp["with_vf_baseline"] = args.baseline
    if args.env == "pendulum":
        hp.setdefault("discrete", False)
        hp.setdefault("act_limit", 2.0)
    if args.continuous:
        hp.setdefault("discrete", False)
        hp.setdefault("act_limit", 1.0)
        env_kwargs["continuous"] = True
    for kv in args.hp:
        key, sep, raw = kv.partition("=")
        if not sep:
            raise SystemExit(f"--hp expects K=V, got {kv!r}")
        try:
            hp[key] = json.loads(raw)
        except json.JSONDecodeError:
            hp[key] = raw

    env_ids = {"cartpole": "CartPole-v1", "pendulum": "Pendulum-v1",
               "lunarlander": "LunarLander-v3"}
    runner = LocalRunner(make(env_ids[args.env], **env_kwargs),
                         algorithm_name=args.algo, device=args.device, **hp)
    device = runner.actor.policy.device
    t0 = time.perf_counter()
    done_updates = 0
    while done_updates < args.updates:
        result = runner.train(epochs=min(5, args.updates - done_updates))
        done_updates = runner.updates
        avg = result["avg_return_last_window"]
        print(f"[local] updates={done_updates} avg_return={avg:.1f}", flush=True)
        if args.target is not None and avg >= args.target:
            print(f"[local] target {args.target} reached", flush=True)
            break
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = runner.actor.steps_served
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"[local] {runner.updates} updates, {steps} env steps in {wall:.2f} s "
          f"({steps / wall:.1f} env steps/s) on {where}", flush=True)
    # Deterministic probe of the final policy (nothing reaches the learner).
    eval_result = runner.evaluate(episodes=args.eval_episodes)
    print(f"[local] greedy eval over {args.eval_episodes} episodes: "
          f"avg_return={eval_result['avg_return']:.1f}", flush=True)


if __name__ == "__main__":
    main()
