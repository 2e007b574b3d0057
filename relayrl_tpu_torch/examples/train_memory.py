"""Long-context showcase on the port: solve a memory task with a sequence policy.

Twin of ``examples/train_memory.py``, with the same flags and
hyperparameters; it runs on the GPU (``--device cpu`` runs it on the CPU).
``RecallEnv`` shows a one-hot cue at t=0, hides it for the rest of the
episode, and scores only the final action: a memoryless MLP policy stays
near chance, the transformer attends back to the cue::

    python -m relayrl_tpu_torch.examples.train_memory --model transformer \
        --epochs 50 --attention flash

With ``--attention flash`` the actor's steps run the flash forward kernel
and every learner update the forward and both backward kernels (d_model 32,
2 heads: head dim 16). The JAX package's golden curve is
``examples/golden/recall_transformer/``.
"""

from __future__ import annotations

import argparse


def recall_hyperparams(model: str, horizon: int, attention: str) -> dict:
    """The learner of the JAX package's golden run
    (``examples/train_memory.py``): REINFORCE with a value baseline, 32
    episodes per update, and a 1-layer transformer (d_model 32, 2 heads)
    or a 64x64 MLP."""
    bucket = max(16, 2 * horizon)
    hp = dict(with_vf_baseline=True, gamma=1.0, lam=0.95, traj_per_epoch=32,
              pi_lr=1e-3, vf_lr=1e-3, train_vf_iters=20,
              bucket_lengths=(bucket,))
    if model == "transformer":
        hp.update(model_kind="transformer_discrete", d_model=32, n_layers=1,
                  n_heads=2, max_seq_len=bucket, attention=attention,
                  attention_block=bucket)
    else:
        hp.update(hidden_sizes=[64, 64])
    return hp


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="transformer", choices=["transformer", "mlp"])
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--horizon", type=int, default=8)
    ap.add_argument("--attention", default="dense",
                    choices=["dense", "blockwise", "flash"],
                    help="attention backend for the transformer policy")
    ap.add_argument("--env-dir", default="./env_memory")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    from relayrl_tpu_torch.envs import RecallEnv
    from relayrl_tpu_torch.runtime.local_runner import LocalRunner

    hp = recall_hyperparams(args.model, args.horizon, args.attention)
    runner = LocalRunner(RecallEnv(horizon=args.horizon), "REINFORCE",
                         env_dir=args.env_dir, seed=0, device=args.device, **hp)
    for block in range(0, args.epochs, 5):
        result = runner.train(epochs=min(5, args.epochs - block))
        avg = result["avg_return_last_window"]
        print(f"[memory/{args.model}] updates={runner.updates} "
              f"avg_return={avg:.2f} (chance=0.5, solved=1.0)", flush=True)
        if avg >= 0.98:
            print(f"[memory/{args.model}] solved", flush=True)
            break


if __name__ == "__main__":
    main()
