"""Pixel-policy training on the port: the DQN-lineage Atari pipeline and
the Nature-CNN learner, in-process.

Twin of ``examples/train_atari.py``, with the same flags and defaults plus
``--device`` (default: the GPU). North-star shapes (BASELINE.md, "PPO Atari
Pong (CNN)"): 84x84x4 frame-stacked grayscale observations into the Nature
trunk. The env is the in-repo catch toy (``SyntheticPixelEnv`` behind the
full preprocessing); the port has no ALE branch, so a real ALE id is
refused::

    python -m relayrl_tpu_torch.examples.train_atari --algo PPO --updates 30
    python -m relayrl_tpu_torch.examples.train_atari --algo PPO \
        --frame-size 36 --frame-stack 2 --frame-skip 2 --raw-size 48 \
        --shaped --updates 400 --ent-coef 0.01 --traj-per-epoch 8 \
        --seed-salt 0

(the second is the ``pixel_ppo_catch`` golden's command). Prints the
rolling average return every 5 updates, then the wall time, the env steps
per second and a greedy evaluation.
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--algo", default="PPO",
                    choices=["PPO", "IMPALA", "DQN", "C51"])
    ap.add_argument("--env", default="synthetic",
                    help='"synthetic" (the in-repo catch toy; the port has '
                         'no ALE branch)')
    ap.add_argument("--frame-size", type=int, default=84)
    ap.add_argument("--updates", type=int, default=30)
    ap.add_argument("--target", type=float, default=None)
    ap.add_argument("--lr", type=float, default=None,
                    help="override the learning rate (unset: PPO uses 1e-3, "
                         "every other algorithm keeps its own default)")
    ap.add_argument("--seed-salt", type=int, default=None,
                    help="pin the pid seed fold-in for reproducible runs")
    ap.add_argument("--frame-skip", type=int, default=4)
    ap.add_argument("--frame-stack", type=int, default=4)
    ap.add_argument("--shaped", action="store_true",
                    help="synthetic env only: add potential-based distance "
                         "shaping")
    ap.add_argument("--raw-size", type=int, default=64,
                    help="synthetic env only: raw board size")
    ap.add_argument("--balls", type=int, default=4,
                    help="synthetic env only: ball drops per episode")
    ap.add_argument("--traj-per-epoch", type=int, default=8)
    ap.add_argument("--ent-coef", type=float, default=None,
                    help="entropy bonus (PPO/IMPALA); 0.01 is a good start")
    ap.add_argument("--out", default=None,
                    help="env_dir for logs/progress.txt (default: cwd)")
    ap.add_argument("--conv", default=None, choices=["nature", "tpu"],
                    help="conv trunk preset: 'nature' or 'tpu' (channel "
                         "widths 64/128/128)")
    ap.add_argument("--bytes", action="store_true",
                    help="uint8 frames end to end: byte-range obs from the "
                         "pipeline, and for DQN/C51 a uint8 replay ring; the "
                         "conv trunk scales /255 on the device either way")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    import torch

    from relayrl_tpu_torch.envs import make_atari
    from relayrl_tpu_torch.runtime.local_runner import LocalRunner

    if args.shaped and args.env != "synthetic":
        ap.error("--shaped only applies to the synthetic env")
    env_kwargs = {}
    if args.env == "synthetic":
        env_kwargs = {"shaped": args.shaped, "raw_size": args.raw_size,
                      "balls": args.balls}
    env = make_atari(args.env, frame_size=args.frame_size,
                     frame_skip=args.frame_skip,
                     frame_stack=args.frame_stack,
                     obs_dtype="uint8" if args.bytes else "float32",
                     **env_kwargs)
    h, w, c = env.obs_shape
    hp = {"obs_shape": [h, w, c], "traj_per_epoch": args.traj_per_epoch}
    if args.bytes and args.algo in ("DQN", "C51"):
        hp["obs_dtype"] = "uint8"  # byte replay ring to match
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        hp["env_dir"] = args.out
    if args.lr is not None:
        hp["pi_lr"] = args.lr
        hp["lr"] = args.lr
    elif args.algo == "PPO":
        hp["pi_lr"] = 1e-3  # pixel PPO default; see --lr help
    if args.seed_salt is not None:
        hp["seed_salt"] = args.seed_salt
    if args.ent_coef is not None:
        hp["ent_coef"] = args.ent_coef
    if args.conv is not None:
        hp["conv_spec"] = args.conv
    if args.algo in ("PPO", "IMPALA"):
        hp["model_kind"] = "cnn_discrete"  # DQN/C51 switch on obs_shape alone
    runner = LocalRunner(env, algorithm_name=args.algo, device=args.device, **hp)
    device = runner.actor.policy.device
    t0 = time.perf_counter()
    done_updates = 0
    while done_updates < args.updates:
        result = runner.train(epochs=min(5, args.updates - done_updates),
                              max_steps=500)
        done_updates = runner.updates
        avg = result["avg_return_last_window"]
        print(f"[atari:{args.algo}] updates={done_updates} "
              f"avg_return={avg:.2f}", flush=True)
        if args.target is not None and avg >= args.target:
            print(f"[atari:{args.algo}] target {args.target} reached",
                  flush=True)
            break
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = runner.actor.steps_served
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"[atari:{args.algo}] {runner.updates} updates, {steps} env steps in "
          f"{wall:.2f} s ({steps / wall:.1f} env steps/s) on {where}", flush=True)
    # Deterministic probe of the final policy (nothing reaches the learner).
    eval_result = runner.evaluate(episodes=10, max_steps=500)
    print(f"[atari:{args.algo}] greedy eval over 10 episodes: "
          f"avg_return={eval_result['avg_return']:.2f}", flush=True)


if __name__ == "__main__":
    main()
