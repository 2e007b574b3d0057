#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``relayrl_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each of which fails the run:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of the serving slice, from
   ``relayrl_tpu_torch/csrc``, one ``nvcc`` per source, all started
   together;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, at the serving slice's shapes and at edge shapes, with the
   kernel's time, the plain version's, a library call's and the bound;
4. serving slice: a 64-lane ``VectorActorHost`` over ``RecallEnv`` at the
   flagship transformer's widths (``__graft_entry__.entry()``'s arch: d_model
   256, 4 layers, 8 heads, max_seq_len 256, bf16, flash attention) for 320
   dispatches with a hot swap halfway; checks the records, the shipped
   trajectories and the kernel launch counts, compares one ``evaluate``
   forward through the kernel with the same forward through the plain
   attention, and breaks a dispatch's time down.

The second-to-last line is the kernels' JSON; the last is
``{"ok": true, "device": {...}}``. Without a CUDA device, or when any
phase fails, the script exits non-zero and prints no ``ok`` line.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time

LANES = 64
DISPATCHES = 320
HORIZON = 300     # RecallEnv episode length: above max_seq_len, so windows roll
N_CUES = 16
SEED = 0
SLICE_ARCH = {
    "kind": "transformer_discrete",
    "d_model": 256,
    "n_layers": 4,
    "n_heads": 8,
    "max_seq_len": 256,
    "attention": "flash",
    "attention_block": 128,
    "has_critic": True,
    "precision": "bfloat16",
}
# The bars of tests/test_flash.py: 3e-2 for bf16, 2e-5 for f32.
TOLERANCE = {"bfloat16": 3e-2, "float32": 2e-5}
# H100 SXM published peaks (dense): HBM bytes/s; FLOP/s by operand type
# (bf16 on the tensor cores, f32 outside them).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events; the inputs stay where the previous call left them, L2
    included)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Mean host wall time of ``fn`` (which must end in a sync itself when
    it touches the device)."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def fused_qkv(B, T, H, D, dtype, device, gen):
    """q, k, v as the model hands them to the kernel: views of one fused
    ``[B, T, 3*H*D]`` projection."""
    import torch

    qkv = torch.randn((B, T, 3, H, D), generator=gen).to(device, dtype)
    return qkv.unbind(2)


def flash_bound(B, T, H, D, dtype_name, causal) -> tuple[float, str]:
    """Least time for the flash forward on these inputs: each of q, k, v
    read once, O and lse2 written once, against HBM bandwidth; the two
    products' FLOPs on the causally live (query, key) pairs against the
    operand type's peak. Returns (ms, what bounds it)."""
    elt = 2 if dtype_name == "bfloat16" else 4
    moved = 4 * B * T * H * D * elt + B * H * T * 4
    pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    flops = 4 * D * pairs
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_flash(device) -> dict:
    """Kernel vs plain version at the slice's shape and the edge shapes;
    times at the slice's shape. Returns the measurements of the shape the
    serving slice runs (bf16, causal, T = 256)."""
    import torch
    import torch.nn.functional as F

    from relayrl_tpu_torch.ops.flash import flash_attention, flash_attention_plain

    B, H, D = LANES, SLICE_ARCH["n_heads"], SLICE_ARCH["d_model"] // SLICE_ARCH["n_heads"]
    gen = torch.Generator().manual_seed(SEED)
    main = None
    for dtype in (torch.bfloat16, torch.float32):
        name = _dtype_name(dtype)
        for causal in (True, False):
            for T in (SLICE_ARCH["max_seq_len"], 17, 1):
                q, k, v = fused_qkv(B, T, H, D, dtype, device, gen)
                out, lse2 = flash_attention(q, k, v, causal)
                torch.cuda.synchronize()
                ref_out, ref_lse2 = flash_attention_plain(q, k, v, causal)
                err_out = (out.float() - ref_out.float()).abs().max().item()
                err_lse2 = (lse2 - ref_lse2).abs().max().item()
                err = max(err_out, err_lse2)
                if not (out.shape == ref_out.shape and lse2.shape == ref_lse2.shape
                        and out.dtype == dtype and math.isfinite(err)
                        and err <= TOLERANCE[name]):
                    raise AssertionError(
                        f"flash_fwd {name} causal={causal} T={T}: max abs err "
                        f"{err} above {TOLERANCE[name]}")
                line = (f"[kernel] flash_fwd {name} causal={causal} "
                        f"q,k,v=[{B},{T},{H},{D}] max_abs_err O={err_out:.3e} "
                        f"lse2={err_lse2:.3e} (tol {TOLERANCE[name]:g})")
                if T == SLICE_ARCH["max_seq_len"]:
                    ms = time_ms(lambda: flash_attention(q, k, v, causal))
                    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, causal),
                                       iters=20)
                    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal))
                    bound_ms, bound_by = flash_bound(B, T, H, D, name, causal)
                    line += (f" ms={ms:.4f} plain_ms={plain_ms:.4f} "
                             f"sdpa_ms={library_ms:.4f} bound_ms={bound_ms:.4f} "
                             f"({bound_by})")
                    if dtype == torch.bfloat16 and causal:
                        main = {"max_abs_err": err, "ms": ms,
                                "plain_ms": plain_ms, "bound_ms": bound_ms,
                                "bound_by": bound_by, "library_ms": library_ms}
                print(line, flush=True)
    return main


class SwapHalfway:
    """The vector host's batched surface, installing ``bundle`` through
    ``maybe_swap`` right before dispatch ``at``."""

    def __init__(self, host, at: int, bundle):
        self.host, self.at, self.bundle = host, at, bundle

    def request_for_actions(self, obs, masks=None, rewards=None):
        if self.host.dispatches == self.at and not self.host.maybe_swap(self.bundle):
            raise AssertionError("hot swap refused")
        return self.host.request_for_actions(obs, masks, rewards)

    def flag_last_action(self, *args, **kwargs):
        return self.host.flag_last_action(*args, **kwargs)


def slice_arch() -> dict:
    from relayrl_tpu_torch.envs import RecallEnv

    env = RecallEnv(HORIZON, N_CUES)
    return {**SLICE_ARCH, "obs_dim": int(env.observation_space.shape[0]),
            "act_dim": int(env.action_space.n)}


def serve(device, arch: dict, lanes: int, dispatches: int) -> dict:
    """Drive the serving slice and check what it produced. Returns the
    launch counts, the host and the run's wall seconds."""
    import numpy as np
    import torch

    from relayrl_tpu_torch.envs import RecallEnv, SyncVectorEnv
    from relayrl_tpu_torch.models import build_policy
    from relayrl_tpu_torch.ops.flash import flash_attention
    from relayrl_tpu_torch.runtime.vector_actor import (
        VectorActorHost,
        run_vector_gym_loop,
    )
    from relayrl_tpu_torch.types import ModelBundle, deserialize_actions
    from relayrl_tpu_torch.weights import params_to_jax

    policy = build_policy(arch, device)
    v1, v2 = (ModelBundle(version, arch, params_to_jax(policy.init_params(
        torch.Generator().manual_seed(SEED + version)))) for version in (1, 2))
    sent = []
    venv = SyncVectorEnv([lambda: RecallEnv(HORIZON, N_CUES)] * lanes)
    horizon = venv.envs[0].horizon

    flash_attention.launches = 0
    host = VectorActorHost(v1, lanes, on_send=lambda lane, p: sent.append((lane, p)),
                           seed=SEED, device=device)
    validate_launches = flash_attention.launches
    t0 = time.perf_counter()
    returns = run_vector_gym_loop(SwapHalfway(host, dispatches // 2, v2), venv,
                                  dispatches, seed=SEED)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention.launches

    act_dim = arch["act_dim"]

    def check_record(rec):
        act = np.asarray(rec.act)
        if not (act.dtype == np.int32 and act.shape == () and 0 <= int(act) < act_dim):
            raise AssertionError(f"bad action {act!r}")
        for key in ("logp_a", "v"):
            val = rec.data[key]
            if not (val.dtype == np.float32 and val.shape == () and np.isfinite(val)):
                raise AssertionError(f"bad {key} {val!r}")

    if host.dispatches != dispatches or host.version != 2 or host.swaps != 1:
        raise AssertionError(f"dispatches {host.dispatches}, version {host.version}, "
                             f"swaps {host.swaps}")
    episodes = dispatches // horizon
    if sorted(lane for lane, _ in sent) != sorted(list(range(lanes)) * episodes):
        raise AssertionError(f"{len(sent)} trajectories shipped, expected "
                             f"{episodes} per lane")
    for _, payload in sent:
        records = deserialize_actions(payload)
        if len(records) != horizon + 1 or not records[-1].done:
            raise AssertionError(f"shipped episode of {len(records)} records")
        for rec in records[:-1]:
            check_record(rec)
    for traj in host.trajectories:
        if len(traj) != dispatches - episodes * horizon:
            raise AssertionError(f"open trajectory of {len(traj)} records")
        for rec in traj.get_actions():
            check_record(rec)
    if any(len(r) != episodes or r[0] not in (0.0, 1.0) for r in returns):
        raise AssertionError(f"episode returns {returns[:4]}...")
    return {"host": host, "wall": wall, "launches": launches,
            "validate_launches": validate_launches}


def compare_evaluate(host, device) -> float:
    """One ``evaluate`` forward through the kernel against the same forward
    with the plain attention, on the host's current params; returns the
    max abs difference over (logp, entropy, v)."""
    import torch

    from relayrl_tpu_torch.ops.flash import flash_attention_plain

    gen = torch.Generator().manual_seed(SEED)
    obs = torch.randn((LANES, host.arch["max_seq_len"], host.arch["obs_dim"]),
                      generator=gen).to(device)
    act = torch.randint(0, host.arch["act_dim"], obs.shape[:2], generator=gen).to(device)
    plain = copy.deepcopy(host.params)
    for block in plain.blocks():
        block.attn_fn = lambda q, k, v: flash_attention_plain(q, k, v, True)[0]
    with torch.inference_mode():
        got = host.policy.evaluate(host.params, obs, act)
        want = host.policy.evaluate(plain, obs, act)
    return max((a - b).abs().max().item() for a, b in zip(got, want))


def dispatch_breakdown(host, device) -> dict:
    """Where one dispatch's time goes, in ms of host wall time: the
    host's window pushes, the batched step (host-to-device copy, forward,
    sampling, copy back), the forward and sampling alone on
    device-resident windows, and the rest of ``request_for_actions``
    (record building and trajectory appends)."""
    import numpy as np
    import torch

    obs = np.zeros((host.num_envs, host.arch["obs_dim"]), np.float32)
    windows = torch.as_tensor(host._windows, device=device)
    lens = torch.as_tensor(host._window_lens, device=device)

    def forward():
        with torch.inference_mode():
            host.policy.step_window(host.params, host._generator, windows, lens)
        torch.cuda.synchronize()

    out = {
        "request": host_ms(lambda: host.request_for_actions(obs)),
        "push": host_ms(lambda: host._push_windows(obs)),
        "step": host_ms(lambda: host._batched_window_fn(
            host.params, host._generator, host._windows, host._window_lens, None)),
        "forward": host_ms(forward),
    }
    out["records"] = out["request"] - out["push"] - out["step"]
    return out


def profile_dispatches(host, n: int = 10) -> None:
    """Device busy share of ``n`` back-to-back dispatches and the kernels
    that take the device time, from ``torch.profiler`` (whose own cost
    lengthens the wall time it is divided by)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    obs = np.zeros((host.num_envs, host.arch["obs_dim"]), np.float32)
    host.request_for_actions(obs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            host.request_for_actions(obs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        print("[profile] device time: not measured (the profiler saw no "
              "device activity)")
        return
    launches = sum(e.count for e in kernels) / n
    print(f"[profile] {n} dispatches: wall {wall_us / n / 1e3:.4f} ms, device "
          f"busy {busy_us / n / 1e3:.4f} ms per dispatch "
          f"({100 * busy_us / wall_us:.1f}% busy), {launches:.0f} device "
          f"operations per dispatch")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[profile]   {e.self_device_time_total / n / 1e3:8.4f} ms "
              f"{100 * e.self_device_time_total / busy_us:5.1f}%  "
              f"x{e.count // n:<3d} {e.key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"[device] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi.splitlines()[0], flush=True)

    # 2. build
    from relayrl_tpu_torch import _kernels

    t0 = time.perf_counter()
    seconds = _kernels.build()
    print(f"[build] {list(_kernels.KERNELS)} in {time.perf_counter() - t0:.2f} s "
          f"(per source: {seconds})", flush=True)

    # 3. kernel vs plain
    main_flash = check_flash(device)

    # 4. serving slice
    arch = slice_arch()
    run = serve(device, arch, LANES, DISPATCHES)
    expected = 3 * DISPATCHES + run["validate_launches"]
    if run["validate_launches"] != arch["n_layers"] or run["launches"] != expected:
        raise AssertionError(
            f"flash_fwd launched {run['launches']} times over {DISPATCHES} "
            f"dispatches (validate {run['validate_launches']}); expected {expected}")
    print(f"[serve] {LANES} lanes x {DISPATCHES} dispatches, swap at "
          f"{DISPATCHES // 2}: flash_fwd launches {run['launches']} = 3 x "
          f"{DISPATCHES} + {run['validate_launches']} (validate_policy)", flush=True)
    err = compare_evaluate(run["host"], device)
    if not err <= TOLERANCE["bfloat16"]:
        raise AssertionError(f"evaluate kernel vs plain attention: {err}")
    print(f"[serve] evaluate [{LANES}, {arch['max_seq_len']}] kernel vs plain "
          f"attention: max abs diff {err:.3e} (tol {TOLERANCE['bfloat16']:g})")
    steps_per_s = LANES * DISPATCHES / run["wall"]
    print(f"[serve] {steps_per_s:.1f} env steps/s ({run['wall'] * 1e3 / DISPATCHES:.3f} "
          f"ms per dispatch, env stepping included) on {smi.splitlines()[0]}")
    parts = dispatch_breakdown(run["host"], device)
    print("[serve] per dispatch, ms: " + ", ".join(
        f"{k}={v:.4f}" for k, v in parts.items()), flush=True)
    profile_dispatches(run["host"])

    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "relayrl_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "relayrl_tpu/ops/flash.py:116",
        "launches": run["launches"],
        **main_flash,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
