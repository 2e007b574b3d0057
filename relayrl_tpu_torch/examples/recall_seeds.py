"""How often the recall golden's learner solves the task, over seeds.

``train_memory`` trains one run, whose outcome depends on its seeds: the
learner's initial params (``seed`` and ``seed_salt``), the actor's
sampling stream (``seed``) and the env's cues. This trains the same
learner (``train_memory.recall_hyperparams``, the transformer) once per
seed ``s`` in ``0 .. --seeds - 1``, with ``seed = seed_salt = s``, for
``--updates`` updates, printing each run's rolling average return every 5
updates, then how many runs reached the golden's bar (0.98)::

    python -m relayrl_tpu_torch.examples.recall_seeds --seeds 32 --attention flash
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=32)
    ap.add_argument("--updates", type=int, default=15)
    ap.add_argument("--attention", default="flash", choices=["dense", "blockwise", "flash"])
    ap.add_argument("--env-dir", default="./env_recall_seeds")
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    from relayrl_tpu_torch.envs import RecallEnv
    from relayrl_tpu_torch.examples.train_memory import recall_hyperparams
    from relayrl_tpu_torch.runtime.local_runner import LocalRunner

    hp = recall_hyperparams("transformer", 8, args.attention)
    solved = 0
    for seed in range(args.seeds):
        runner = LocalRunner(RecallEnv(horizon=8), "REINFORCE",
                             env_dir=os.path.join(args.env_dir, str(seed)), seed=seed,
                             seed_salt=seed, device=args.device, **hp)
        curve = []
        while runner.updates < args.updates:
            result = runner.train(epochs=min(5, args.updates - runner.updates))
            curve.append(round(result["avg_return_last_window"], 3))
        solved += curve[-1] >= 0.98
        print(f"[recall-seeds] seed {seed}: avg return every 5 updates {curve}", flush=True)
    print(f"[recall-seeds] {solved} of {args.seeds} runs at >= 0.98 after {args.updates} "
          f"updates", flush=True)


if __name__ == "__main__":
    main()
