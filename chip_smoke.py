#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``relayrl_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each of which fails the run:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of the port (``flash_fwd``, ``flash_bwd``,
   ``ring_flash``), from ``relayrl_tpu_torch/csrc``, one ``nvcc`` per
   source, all started together; prints ``nvcc -Xptxas -v``'s registers
   and spills; counts the tensor-core instructions in the SASS of each
   bf16 instantiation of K1-K6 (``cuobjdump -sass``) and fails on a count
   other than ``TENSOR_CORE_COUNTS``' or a spill;
3. kernel vs plain: each kernel (K1 forward, K2 dq, K3 dk/dv) against its
   plain PyTorch version on the card, at the slices' shapes and at edge
   shapes (head dims 8 and 24 through ``flash_attention``'s padding,
   forward and gradients), with the kernel's time, the plain version's, a
   library call's and the bound; the whole backward as the learner runs
   it (delta, the prescaled q, K2 and K3 through ``torch.autograd.grad``)
   beside SDPA's;
4. serving slice: a 64-lane ``VectorActorHost`` over ``RecallEnv`` at the
   flagship transformer's widths (``__graft_entry__.entry()``'s arch: d_model
   256, 4 layers, 8 heads, max_seq_len 256, bf16, flash attention) for 320
   dispatches with a hot swap halfway; checks the records, the shipped
   trajectories and the kernel launch counts, compares one ``evaluate``
   forward through the kernel with the same forward through the plain
   attention, and breaks a dispatch's time down;
5. learner slice: the port's ``REINFORCE`` at the same arch (value
   baseline, 8 episodes per epoch, 80 value iterations, one 256 bucket)
   trains on the episodes of its own 64-lane actor host, two waves of 64
   ``RecallEnv(255)`` episodes, 16 updates, with a hot swap after each;
   checks the launch counts of every update (336 K1, 4 K2, 4 K3), the
   versions, the metrics and the params, compares the first update through
   the kernels with the same update through the plain attention, and
   times and profiles an update;
6. ring kernels vs plain: K4, K5 and K6 (the ring's chunk forward, dq and
   dk/dv) against their plain versions at the sp learner's chunk shape and
   at edge shapes, with times, plain times and bounds; the flash ring at
   head dim 8 (padded) against the ring of plain chunk versions, forward
   and gradients; then
   ``chunked_flash_local`` (K4 over every chunk pair of one sequence)
   against K1 at the serving shape;
7. sequence-parallel learner: the same REINFORCE with ``attention="ring"``
   through ``make_sharded_update(..., shard_time=True)`` over an sp = 4 mesh
   of the one card, 4 updates on phase 5's first wave; checks the launch
   counts of every update (3360 K4, 40 K5, 40 K6, no K1-K3), compares the
   first update through the kernels with the same update through the
   chunk kernels' plain versions and ``evaluate`` through the ring with
   ``evaluate`` through K1, and times and profiles an update;
8. wide heads: the transformer at d_model 512 with 4 heads of 128 and at
   d_model 1024 with 4 heads of 256 (2 layers, T 256, bf16, flash) builds
   on the card; 8 port actors serve it; its ``evaluate`` and first
   REINFORCE update through K1-K3 match the plain attention (phases 4 and
   5's bars), with exact launch counts;
9. the local loop: ``LocalRunner`` on CartPole-v1 (``mlp_discrete``, the
   cartpole_reinforce_baseline golden's hyperparameters) for a few
   updates; and ``LocalRunner`` on ``RecallEnv(8)`` with the
   recall_transformer golden's flash transformer, its actor serving
   through the KV cache, its K1, K2 and K3 launches counted per update and
   over the run; in both, one update on the card held to the same update
   on the CPU (f32);
10. cached decode: a ``PolicyActor`` serving the flagship arch through its
   KV cache beside one serving through the window, over ``RecallEnv``
   episodes that outgrow the window, with a hot swap: the same values
   before the window rolls (the bf16 bar), one prefill for the swap, no
   flash kernel on the cached path, and the ms per env step of both;
11. the distributed loop: phase 5's learner in a ``TrainingServer``
   (``relayrl_tpu_torch/examples/chaos_server.py``, a process of its own
   on the card) fed over ZMQ by a ``VectorAgent`` of 8
   ``RecallEnv(255)`` lanes in this process, 4 updates; checks the ingest
   accounting (accepted == max_seq == sent, contiguous, no drop), no
   learner error, the server's K1/K2/K3 launches per update (336/4/4), the
   agent's K1 launches per dispatch (3), keyframe and delta frames
   applied, and the agent's params bit-equal (sha256) to the server's
   publish at the same version; then SIGKILLs the server, plays a wave
   into the outage, restarts it with ``resume`` (params and Adam steps
   equal to the checkpoint's) and requires it to train past the kill, the
   agent to advance, and after a spool replay accepted == max_seq == sent
   with duplicates; prints env steps/s, ms per update and publish bytes
   (not gated). The server runs the reference's default config, guardrails
   on (no rejection, strike, trip or rollback on this clean run; probes
   live), and profiles its learner over updates 2-4 (device busy ms and
   operations per update, the learner thread's CPU and run-queue time);
12. guardrails on the card: phase 5's learner trained twice from the same
   params and batches with the probes off and once on, bit-equal, at
   336/4/4 launches per update, and the probes' device cost; then a
   ``chaos_server`` over gRPC from the default config with two
   ``VectorAgent``s: B's ``nan_poison``ed sends rejected ``nonfinite``
   until its lanes are quarantined, then typed quarantine nacks its spool
   discards, while A's clean epochs are accepted exactly and train; then
   a wave of finite rewards of 1e38 drives the params non-finite and the
   watchdog rolls back exactly once to the newest healthy checkpoint
   (params and Adam steps equal), under a higher version, with a forced
   keyframe A installs sha256-equal; no agent installs non-finite params.

Phases 3 and 6 also hold every kernel to its plain version at head dims
128 and 256 (bf16 and f32, [8, 256, 4, 128], [8, 256, 2, 256], [8, 64, 4,
128] and [8, 64, 2, 256] chunks, ragged T and C, and the sp = 4 ring at
head dim 256, whose chunk kernels resume their state over 4 rounds) and
at head dims 96 and 192 (padded to 128 and 256), and time K1-K6 there.

The second-to-last line is the kernels' JSON; the last is
``{"ok": true, "device": {...}}``. Without a CUDA device, or when any
phase fails, the script exits non-zero and prints no ``ok`` line.
"""

from __future__ import annotations

import copy
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

LANES = 64
DISPATCHES = 320
HORIZON = 300     # RecallEnv episode length: above max_seq_len, so windows roll
N_CUES = 16
SEED = 0
# The cached-decode phase (10): CACHED_EPISODES RecallEnv(HORIZON) episodes
# served by one actor through the KV cache and one through the window, a
# hot swap at step CACHED_SWAP_AT of the first.
CACHED_EPISODES = 2
CACHED_SWAP_AT = 128
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
# The learner slice: REINFORCE's defaults plus these (one [8, 256] batch
# per update; horizon 255 ships 255 steps and the done marker).
LEARNER = {"with_vf_baseline": True, "traj_per_epoch": 8,
           "train_vf_iters": 80, "bucket_lengths": [256]}
LEARNER_HORIZON = 255
LEARNER_WAVES = 2
# The sequence-parallel learner: the same learner with attention="ring"
# over an sp mesh of SP shards of the one card (local chunks of 64 rows),
# trained for SP_UPDATES updates on batches of phase 5's first wave.
SP = 4
SP_UPDATES = 4
# The distributed loop (phase 11): the port's chaos server (a
# TrainingServer in its own process) learns phase 5's learner from one
# VectorAgent of DIST_LANES RecallEnv(LEARNER_HORIZON) lanes in this
# process, so one wave of episodes is one epoch; DIST_UPDATES updates,
# then the server is SIGKILLed, the agent plays OUTAGE_WAVES waves into the
# outage, and the server restarts with resume.
DIST_LANES = 8
DIST_UPDATES = 4
OUTAGE_WAVES = 1
DIST_TIMEOUT_S = 240
# The guardrails phase (12): phase 5's learner in a chaos_server process
# over gRPC (grpc imports on the card's machine; checked once, never
# decided at run time), built from the reference's default config
# (enforce, watchdog, probes, rollback on). Agent A is phase 11's clean
# VectorAgent (one epoch per wave); agent B's GUARD_LANES_B lanes carry a
# nan_poison fault on every send. After GUARD_CLEAN_WAVES clean epochs,
# A plays one wave whose every reward is DIVERGE_REWARD: finite (it
# passes validation) but large enough that the update's returns overflow
# float32 and the params go non-finite. PROBE_UPDATES updates from the
# same params and batches, probes on and off, must agree bit for bit.
GUARD_TRANSPORT = "grpc"
GUARD_LANES_B = 2
GUARD_CLEAN_WAVES = 2
DIVERGE_REWARD = 1e38
PROBE_UPDATES = 2
# The bars of tests/test_flash.py: 3e-2 for bf16, 2e-5 for f32.
TOLERANCE = {"bfloat16": 3e-2, "float32": 2e-5}
# Gradients: 5e-5 in f32 (tests/test_flash.py's gradient bar); in bf16 3e-2
# of each gradient tensor's max |value| (ds, p and the outputs each take
# one bf16 rounding), and never below the f32 bar (at T = 1 dq is zero up
# to rounding, so its max |value| is itself rounding noise).
GRAD_TOLERANCE_F32 = 5e-5
# One learner update through the kernels vs through the plain attention
# (bf16): metrics within 1e-2 (relative and absolute); every parameter
# within twice Adam's step bound of its optimizer (a small gradient that
# rounds differently flips the sign of its normalized step), and the mean
# |difference| within 5% of the mean movement.
UPDATE_METRIC_TOL = 1e-2
UPDATE_MEAN_DIFF_SHARE = 0.05
# The first update of each wave trains on episodes the actors drew from
# the learner's current version, so KL (behavior log-probs from the
# actors' window readout vs the learner's full forward) is zero up to bf16
# rounding.
ON_POLICY_KL_TOL = 1e-3
# H100 SXM published peaks (dense): HBM bytes/s; FLOP/s by operand type
# (bf16 on the tensor cores, f32 outside them).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# Device clock cycles per second for torch.cuda._sleep: the H100 SXM's top
# SM clock (1.98 GHz), so a sleep lasts at least the seconds asked for.
SLEEP_CYCLES_PER_S = 1.98e9
# A tensor-core product in SASS: mma.sync (HMMA) or wgmma (HGMMA).
TENSOR_CORE_OP = re.compile(r"\b(?:HMMA|HGMMA)\b")
# The bf16 tensor-core kernels: (library, the mangled name of an
# instantiation with the kernel's name and head dim as groups 1 and 2, the
# kernels' names).
TENSOR_CORE_KERNELS = (
    ("flash_fwd", r"(flash_fwd)_bf16_kernelILi(\d+)E", ("flash_fwd",)),
    ("flash_bwd", r"(flash_(?:dq|dkv))_bf16_kernelILi(\d+)E", ("flash_dq", "flash_dkv")),
    ("ring_flash", r"(ring_chunk_(?:fwd|dq|dkv))_bf16_kernelILi(\d+)E",
     ("ring_chunk_fwd", "ring_chunk_dq", "ring_chunk_dkv")),
)
# The ring's backward kernels run the flash backward's tile steps
# (csrc/flash_bwd_tile.cuh): {ring kernel: its flash counterpart}.
SHARED_TILE_STEP = {"ring_chunk_dq": "flash_dq", "ring_chunk_dkv": "flash_dkv"}
# Tensor-core instructions in the SASS of each bf16 instantiation, {kernel:
# {head dim: count}}: the tile steps' products, unrolled over a 64-row tile
# in a masked and an unmasked body, grow with D; K4, K5 and K6 share K1's,
# K2's and K3's steps. At D = 128 a K3 or K6 block accumulates dk and dv
# over half the head dim (bwd::kDkvCols), so 48 products per 16-query
# chunk where all 128 columns would take 64. At D = 256 every block owns
# part of its output's columns: K1/K4 128 of O's (32 products of S and 16
# of P.V per 16-key chunk), K2/K5 128 of dq's (16 of dS.K), K3/K6 64 of
# dk's and dv's (8 + 8); the backward's S and dP run as a loop of 4 unrolled
# k-steps a trip (bwd::kScoreSteps), so 16 products of them in the SASS.
_FWD_HMMA = {16: 32, 32: 64, 64: 128, 128: 256, 256: 384}
_DQ_HMMA = {16: 48, 32: 96, 64: 192, 128: 384, 256: 256}
_DKV_HMMA = {16: 64, 32: 128, 64: 256, 128: 384, 256: 256}
TENSOR_CORE_COUNTS = {"flash_fwd": _FWD_HMMA, "ring_chunk_fwd": _FWD_HMMA,
                      "flash_dq": _DQ_HMMA, "ring_chunk_dq": _DQ_HMMA,
                      "flash_dkv": _DKV_HMMA, "ring_chunk_dkv": _DKV_HMMA}
# The wide head dims the kernels take, and the shapes phases 3 and 6 check
# them at: [8, 256, 4, 128] and [8, 256, 2, 256] for the flash kernels (a
# d_model 512 transformer's 4 heads, a d_model 512 one's 2 heads),
# [8, 64, 4, 128] and [8, 64, 2, 256] chunks for the ring's. Head dims 96
# and 192 reach them through the padding.
WIDE_D, WIDE_H = 128, 4
WIDEST_D, WIDEST_H = 256, 2
# The wide transformers (phase 8), at the flagship's context, trained by
# the same learner: head dim 128 (d_model 512, 4 heads) and 256, the
# widest kernel (d_model 1024, 4 heads).
WIDE_ARCH = {**SLICE_ARCH, "d_model": 512, "n_heads": 4, "n_layers": 2}
WIDEST_ARCH = {**SLICE_ARCH, "d_model": 1024, "n_heads": 4, "n_layers": 2}
# The local loop (phase 9): the cartpole_reinforce_baseline golden's
# hyperparameters (examples/golden/cartpole_reinforce_baseline/config.json)
# for LOCAL_UPDATES updates, and the recall_transformer golden's
# (examples/train_memory.py --model transformer --attention flash, the
# port's twin's recall_hyperparams) for RECALL_UPDATES.
CARTPOLE_HP = {"with_vf_baseline": True, "gamma": 0.98, "lam": 0.97, "pi_lr": 3e-4,
               "vf_lr": 1e-3, "train_vf_iters": 80, "traj_per_epoch": 8,
               "hidden_sizes": [128, 128]}
RECALL_HORIZON = 8
LOCAL_UPDATES = 5
RECALL_UPDATES = 3
# One local-loop update on the card against the same update on the CPU,
# f32 with TF32 off (tests/test_torch_mlp.py's bars): metrics at rtol 1e-4
# plus atol 1e-6, a floor for the metrics that are ~0 by construction
# (AdvMean; KL on this on-policy batch, rounding noise of order 1e-9);
# params at atol 1e-5, except where Adam normalized rounding noise: an
# element whose bias-corrected RMS gradient sqrt(v_hat), on the CPU side,
# fell below ADAM_FLOOR at any step took a step set by f32 rounding (a
# gradient summed to the order of Adam's eps from much larger terms
# carries a rounding error that is a sizeable share of it, and
# m_hat / (sqrt(v_hat) + eps) scales that share up to a step of up to lr),
# so it is held to Adam's step bound, lr per step taken.
MLP_METRIC_RTOL, MLP_METRIC_ATOL, MLP_PARAM_ATOL = 1e-4, 1e-6, 1e-5
ADAM_FLOOR = 1e-6


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events; the inputs stay where the previous call left them, L2
    included). The timed calls queue up behind a device sleep that
    outlasts their host issue time, so a kernel shorter than its launch's
    host cost is timed on the device, not at the host's issue rate."""
    import torch

    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) / warmup * iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(1.5 * host_s, 1.0) * SLEEP_CYCLES_PER_S))
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


def flash_bwd_bound(B, T, H, D, dtype_name, causal, kernel) -> tuple[float, str]:
    """Least time for one backward pass on these inputs. Each reads q, k,
    v and do once and lse2 and delta (f32) once; dq writes dq, dkv writes
    dk and dv. FLOPs on the causally live (query, key) pairs: dq 3
    products (scores, dp, ds.k), dkv 4 (scores, dp, p^T.do, ds^T.q)."""
    elt = 2 if dtype_name == "bfloat16" else 4
    outputs = 1 if kernel == "dq" else 2
    moved = (4 + outputs) * B * T * H * D * elt + 2 * B * H * T * 4
    pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    flops = (6 if kernel == "dq" else 8) * D * pairs
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def build_log(name: str) -> str:
    """nvcc's output for the built library of kernel ``name``: this
    process's, or the one kept beside the library by the build that made
    it."""
    from relayrl_tpu_torch import _kernels

    if name in _kernels.BUILD_LOGS:
        return _kernels.BUILD_LOGS[name]
    return _kernels.library_path(name).with_suffix(".log").read_text()


def sass(name: str) -> str:
    """``cuobjdump -sass`` of the built library of kernel ``name``, with the
    ``cuobjdump`` of the toolkit whose ``nvcc`` built it."""
    from relayrl_tpu_torch import _kernels

    tool = Path(_kernels._nvcc()).with_name("cuobjdump")
    if not tool.is_file():
        raise RuntimeError(f"cuobjdump not found next to nvcc ({tool})")
    return subprocess.run([str(tool), "-sass", str(_kernels.library_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout


def count_tensor_core_ops(text: str) -> dict[str, int]:
    """Per function section of ``cuobjdump -sass`` output (keyed by the
    mangled name), the count of tensor-core products (``HMMA``, ``HGMMA``);
    functions without one count 0."""
    counts: dict[str, int] = {}
    name = None
    for line in text.splitlines():
        header = re.search(r"Function\s*:\s*(\S+)", line)
        if header:
            name = header.group(1)
            counts.setdefault(name, 0)
        elif name is not None and TENSOR_CORE_OP.search(line):
            counts[name] += 1
    return counts


def _ptxas_per_function(log: str, pattern: str, read) -> dict:
    """``read(match)`` of the first line matching ``pattern`` after each
    function header of ``nvcc -Xptxas=-v`` output, by mangled name."""
    out = {}
    name = None
    for line in log.splitlines():
        header = re.search(r"(?:Compiling entry function|Function properties for)"
                           r"\s+'?([^'\s]+)'?", line)
        if header:
            name = header.group(1)
            continue
        found = re.search(pattern, line)
        if found and name is not None:
            out[name] = read(found)
    return out


def ptxas_spills(log: str) -> dict[str, tuple[int, int]]:
    """Per function in ``nvcc -Xptxas=-v`` output (mangled name), ptxas's
    ``(spill store bytes, spill load bytes)``."""
    return _ptxas_per_function(log, r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                               lambda m: (int(m.group(1)), int(m.group(2))))


def ptxas_registers(log: str) -> dict[str, int]:
    """Per function in ``nvcc -Xptxas=-v`` output, the registers it uses."""
    return _ptxas_per_function(log, r"Used (\d+) registers", lambda m: int(m.group(1)))


def check_tensor_cores() -> dict[str, dict[int, int]]:
    """Prints the tensor-core instructions (HMMA or HGMMA) in the SASS of
    each bf16 instantiation of K1-K6 (``cuobjdump -sass`` of the built
    ``flash_fwd``, ``flash_bwd`` and ``ring_flash`` libraries, counted per
    function section), ptxas's registers and spills for them, and the ring
    backward's counts beside those of the flash kernels whose tile steps
    they share. Fails when ``cuobjdump`` is missing, an instantiation is
    missing, a count is not :data:`TENSOR_CORE_COUNTS`' or ptxas reports a
    spill. Returns {kernel: {head dim: count}}."""
    from relayrl_tpu_torch.ops.flash import KERNEL_HEAD_DIMS

    found: dict[str, dict[int, int]] = {}
    for library, pattern, kernels in TENSOR_CORE_KERNELS:
        counts = count_tensor_core_ops(sass(library))
        log = build_log(library)
        spills, registers = ptxas_spills(log), ptxas_registers(log)
        for kernel in kernels:
            found[kernel] = {}
        for fn, n in counts.items():
            m = re.search(pattern, fn)
            if m is None:
                continue
            kernel, d = m.group(1), int(m.group(2))
            spill = spills.get(fn)
            print(f"[sass] {kernel} bf16 D={d}: {n} tensor-core instructions "
                  f"(HMMA/HGMMA; expected {TENSOR_CORE_COUNTS[kernel].get(d)}); "
                  f"{registers.get(fn)} registers; ptxas spill stores/loads {spill}",
                  flush=True)
            if n != TENSOR_CORE_COUNTS[kernel].get(d) or spill != (0, 0):
                raise AssertionError(f"{fn}: {n} tensor-core instructions, spills {spill}")
            found[kernel][d] = n
    for kernel, dims in found.items():
        if sorted(dims) != sorted(KERNEL_HEAD_DIMS):
            raise AssertionError(f"{kernel} bf16 instantiations in the SASS: "
                                 f"{sorted(dims)}, expected {KERNEL_HEAD_DIMS}")
    for ring, flash in SHARED_TILE_STEP.items():
        print(f"[sass] {ring} HMMA per head dim {found[ring]}, {flash} (the same "
              f"tile step) {found[flash]}", flush=True)
    return found


def grad_bar(dtype, want) -> float:
    """The gradient bar: 5e-5 in f32; in bf16 3e-2 of the gradient's max
    |value|, never below the f32 bar."""
    import torch

    if dtype == torch.float32:
        return GRAD_TOLERANCE_F32
    return max(GRAD_TOLERANCE_F32, TOLERANCE["bfloat16"] * want.float().abs().max().item())


def check_flash_bwd(device) -> dict:
    """K2 and K3 against their plain versions at the learner slice's shape
    (``[8, 256, 8, 32]`` bf16 causal) and at edge shapes: T = 1, 17, 130
    (f32 and bf16, causal and not), head dim 64 at T = 130, and in bf16,
    causal and not, the tensor-core kernels' tile edges: T = 64 (one whole
    tile), T = 65 (one row past it) and head dim 16; and at the widest head
    dims, [8, T, 4, 128] and [8, T, 2, 256] (T = 256 and 130, f32 and bf16,
    causal and not). Times at the slice's shape, at [8, 256, 4, 128] and at
    [8, 256, 2, 256] (bf16 causal): each kernel alone (on a prescaled q),
    and the whole backward as the learner runs it (``torch.autograd.grad``
    through ``flash_attention``: delta, the prescaled q, K2 and K3) beside
    SDPA's backward. Returns {"flash_dq": ..., "flash_dkv": ...} for the
    slice's shape, each with the head dim 128 and 256 measurements under
    ``"d128"`` and ``"d256"``."""
    import torch
    import torch.nn.functional as F

    from relayrl_tpu_torch.ops.flash import (
        _launch_dkv,
        _launch_dq,
        flash_attention,
        flash_attention_delta,
        flash_attention_dkv_plain,
        flash_attention_dq_plain,
        flash_attention_plain,
        prescale_q,
    )

    B, H = LEARNER["traj_per_epoch"], SLICE_ARCH["n_heads"]
    D = SLICE_ARCH["d_model"] // H
    T_main = SLICE_ARCH["max_seq_len"]
    gen = torch.Generator().manual_seed(SEED + 1)
    main_case = (torch.bfloat16, True, T_main, H, D)
    wide_case = (torch.bfloat16, True, T_main, WIDE_H, WIDE_D)
    widest_case = (torch.bfloat16, True, T_main, WIDEST_H, WIDEST_D)
    timed = {wide_case: "d128", widest_case: "d256"}
    dtypes = (torch.bfloat16, torch.float32)
    cases = [main_case, wide_case, widest_case]
    cases += [(dtype, causal, T, H, D) for dtype in dtypes
              for causal in (True, False) for T in (1, 17, 130)]
    cases += [(torch.bfloat16, True, 130, H, 64), (torch.float32, False, 130, H, 64)]
    cases += [(torch.bfloat16, causal, T, H, d) for causal in (True, False)
              for T, d in ((64, D), (65, D), (65, 16), (130, 16))]
    cases += [(dtype, causal, T, h, d) for h, d in ((WIDE_H, WIDE_D), (WIDEST_H, WIDEST_D))
              for dtype in dtypes for causal in (True, False) for T in (T_main, 130)
              if (dtype, causal, T, h, d) not in (wide_case, widest_case)]
    main = {"flash_dq": {}, "flash_dkv": {}}
    for case in cases:
        dtype, causal, T, H, d = case
        name = _dtype_name(dtype)
        q, k, v = fused_qkv(B, T, H, d, dtype, device, gen)
        out, lse2 = flash_attention_plain(q, k, v, causal)
        do = torch.randn((B, T, H, d), generator=gen).to(device, dtype)
        delta = flash_attention_delta(out, do)
        args = (q, k, v, lse2, do, delta, causal)
        kernel_args = (prescale_q(q), *args[1:])
        got = {"flash_dq": (_launch_dq(*kernel_args),),
               "flash_dkv": _launch_dkv(*kernel_args)}
        torch.cuda.synchronize()
        want = {"flash_dq": (flash_attention_dq_plain(*args),),
                "flash_dkv": flash_attention_dkv_plain(*args)}
        for kernel in got:
            errs, bars = [], []
            for g, w in zip(got[kernel], want[kernel]):
                bar = grad_bar(dtype, w)
                err = (g.float() - w.float()).abs().max().item()
                if not (g.shape == w.shape and g.dtype == dtype
                        and math.isfinite(err) and err <= bar):
                    raise AssertionError(
                        f"{kernel} {name} causal={causal} T={T} D={d}: max "
                        f"abs err {err} above {bar}")
                errs.append(err)
                bars.append(bar)
            line = (f"[kernel] {kernel} {name} causal={causal} "
                    f"q,k,v,do=[{B},{T},{H},{d}] max_abs_err "
                    + "/".join(f"{e:.3e}" for e in errs) + " (tol "
                    + "/".join(f"{b:.3e}" for b in bars) + ")")
            if case == main_case or case in timed:
                launch = _launch_dq if kernel == "flash_dq" else _launch_dkv
                plain = (flash_attention_dq_plain if kernel == "flash_dq"
                         else flash_attention_dkv_plain)
                ms = time_ms(lambda: launch(*kernel_args))
                plain_ms = time_ms(lambda: plain(*args), iters=20)
                bound_ms, bound_by = flash_bwd_bound(
                    B, T, H, d, name, causal, kernel.removeprefix("flash_"))
                measured = {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": bound_ms, "bound_by": bound_by}
                if case == main_case:
                    main[kernel].update(measured)
                else:
                    main[kernel][timed[case]] = {"shape": [B, T, H, d], **measured}
                line += (f" ms={ms:.4f} plain_ms={plain_ms:.4f} "
                         f"bound_ms={bound_ms:.4f} ({bound_by})")
            print(line, flush=True)
        if case == main_case or case in timed:
            # The yardstick: SDPA's backward for the same q, k, v and do
            # (it computes dq, dk and dv in one call).
            qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                          for x in (q, k, v))
            sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
            dot = do.transpose(1, 2)
            library_ms = time_ms(lambda: torch.autograd.grad(
                sdpa_out, (qt, kt, vt), dot, retain_graph=True))
            # The port's whole backward on the same inputs, as the learner
            # runs it.
            qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
            flash_out, _ = flash_attention(qg, kg, vg, causal)
            backward_ms = time_ms(lambda: torch.autograd.grad(
                flash_out, (qg, kg, vg), do, retain_graph=True))
            print(f"[kernel] backward {name} causal={causal} [{B},{T},{H},{d}]: "
                  f"flash_attention (delta + prescale + flash_dq + flash_dkv) "
                  f"ms={backward_ms:.4f}, sdpa backward ms={library_ms:.4f} "
                  f"({backward_ms / library_ms:.2f}x)", flush=True)
            if case == main_case:
                profile_device(lambda: torch.autograd.grad(
                    flash_out, (qg, kg, vg), do, retain_graph=True), 20, "backward")
            for kernel in main:
                into = main[kernel] if case == main_case else main[kernel][timed[case]]
                into["library_ms"] = library_ms
                into["backward_ms"] = backward_ms
    for kernel in main:
        main[kernel]["head_dims"] = sorted({case[-1] for case in cases})
    return main


def check_flash(device) -> dict:
    """K1 against its plain version on q, k, v laid out as the model passes
    them, in bf16 and f32, causal and not: at the serving slice's shape
    ([64, 256, 8, 32]) and at T = 17 and 1 there; at the learner slice's
    ([8, 256, 8, 32]); at [8, T, 8, D] for the tensor-core kernel's tile
    edges (T = 64, 65), head dims 16 and 64 (T = 130), and head dims 8 and
    24 (T = 65, padded to 16 and 32 by ``flash_attention``); and at the
    wide head dims, [8, T, 4, 128] and [8, T, 2, 256] (T = 256 and 130), and
    head dims 96 and 192 (T = 65, padded to 128 and 256). At the padded
    head dims the gradients through ``flash_attention`` are held to the
    plain backward too. Times K1 and SDPA, with the bound, at the serving
    shape (and the plain version, bf16 causal), at the learner's and at
    [8, 256, 4, 128] and [8, 256, 2, 256] (bf16 causal, and the plain
    version). Returns the serving shape's bf16 causal measurements, with
    the learner shape's and the head dim 128 and 256 ones (``"d128"``,
    ``"d256"``) beside them."""
    import torch
    import torch.nn.functional as F

    from relayrl_tpu_torch.ops import flash
    from relayrl_tpu_torch.ops.flash import (
        flash_attention,
        flash_attention_bwd_plain,
        flash_attention_plain,
    )

    H, D = SLICE_ARCH["n_heads"], SLICE_ARCH["d_model"] // SLICE_ARCH["n_heads"]
    T_main, B_learn = SLICE_ARCH["max_seq_len"], LEARNER["traj_per_epoch"]
    serving = (torch.bfloat16, True, LANES, T_main, H, D)
    learner = (torch.bfloat16, True, B_learn, T_main, H, D)
    wide = (torch.bfloat16, True, B_learn, T_main, WIDE_H, WIDE_D)
    widest = (torch.bfloat16, True, B_learn, T_main, WIDEST_H, WIDEST_D)
    timed = {wide: "d128", widest: "d256"}
    dtypes = (torch.bfloat16, torch.float32)
    cases = [serving, learner, wide, widest]
    cases += [(dtype, causal, LANES, T, H, D) for dtype in dtypes for causal in (True, False)
              for T in (T_main, 17, 1) if (dtype, causal, LANES, T, H, D) != serving]
    cases += [(dtype, causal, B_learn, T, H, d) for dtype in dtypes for causal in (True, False)
              for T, d in ((64, D), (65, D), (130, 16), (130, 64), (65, 8), (65, 24))]
    cases += [(dtype, causal, B_learn, T, h, d) for dtype in dtypes
              for causal in (True, False)
              for h, T, d in ((WIDE_H, T_main, WIDE_D), (WIDE_H, 130, WIDE_D), (WIDE_H, 65, 96),
                              (WIDEST_H, T_main, WIDEST_D), (WIDEST_H, 130, WIDEST_D),
                              (WIDEST_H, 65, 192))
              if (dtype, causal, B_learn, T, h, d) not in timed]
    gen = torch.Generator().manual_seed(SEED)
    main = {}
    for case in cases:
        dtype, causal, B, T, H, d = case
        name = _dtype_name(dtype)
        padded = d not in flash.KERNEL_HEAD_DIMS
        q, k, v = (x.detach().requires_grad_(padded)
                   for x in fused_qkv(B, T, H, d, dtype, device, gen))
        out, lse2 = flash_attention(q, k, v, causal)
        torch.cuda.synchronize()
        ref_out, ref_lse2 = flash_attention_plain(q.detach(), k.detach(), v.detach(), causal)
        errs = [(out.float() - ref_out.float()).abs().max().item(),
                (lse2 - ref_lse2).abs().max().item()]
        bars = [TOLERANCE[name]] * 2
        shapes_ok = (out.shape == ref_out.shape and lse2.shape == ref_lse2.shape
                     and out.dtype == dtype)
        if padded:
            do = torch.randn((B, T, H, d), generator=gen).to(device, dtype)
            got = torch.autograd.grad(out, (q, k, v), do)
            want = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                             out.detach(), lse2, do, causal)
            for g, w in zip(got, want):
                errs.append((g.float() - w.float()).abs().max().item())
                bars.append(grad_bar(dtype, w))
                shapes_ok = shapes_ok and g.shape == w.shape and g.dtype == dtype
        if not shapes_ok or not all(math.isfinite(e) and e <= b for e, b in zip(errs, bars)):
            raise AssertionError(
                f"flash_fwd {name} causal={causal} [{B},{T},{H},{d}]: max abs errs "
                f"{errs} above {bars}")
        line = (f"[kernel] flash_fwd {name} causal={causal} q,k,v=[{B},{T},{H},{d}]"
                + (" (padded; O, lse2, dq, dk, dv)" if padded else " (O, lse2)")
                + " max_abs_err " + "/".join(f"{e:.3e}" for e in errs) + " (tol "
                + "/".join(f"{b:.3e}" for b in bars) + ")")
        if case in (serving, learner) or case in timed:
            ms = time_ms(lambda: flash_attention(q, k, v, causal))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal))
            bound_ms, bound_by = flash_bound(B, T, H, d, name, causal)
            line += (f" ms={ms:.4f} sdpa_ms={library_ms:.4f} bound_ms={bound_ms:.4f} "
                     f"({bound_by})")
            if case == serving:
                plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, causal), iters=20)
                line += f" plain_ms={plain_ms:.4f}"
                main.update({"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": bound_ms, "bound_by": bound_by,
                             "library_ms": library_ms})
            elif case == learner:
                main.update({"learner_ms": ms, "learner_library_ms": library_ms,
                             "learner_bound_ms": bound_ms})
            else:
                plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, causal), iters=20)
                line += f" plain_ms={plain_ms:.4f}"
                main[timed[case]] = {"shape": [B, T, H, d], "max_abs_err": max(errs),
                                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                     "bound_by": bound_by, "library_ms": library_ms}
        print(line, flush=True)
    main["head_dims"] = sorted({case[-1] for case in cases})
    return main


def ring_chunk_bound(B, C, H, D, dtype_name, kernel, mode) -> tuple[float, str]:
    """Least time for one ring chunk kernel on these inputs. Each reads its
    bf16/f32 inputs once (K4: q, k, v; K5, K6: q, k, v, do) and its f32
    carried state once (K4: acc, m, l; K5: lse2, delta, dq; K6: lse2,
    delta, dk, dv), and writes its f32 state once. FLOPs on the live
    (query, key) pairs (every pair under FULL, the causal half under DIAG):
    K4 2 products, K5 3, K6 4."""
    from relayrl_tpu_torch.parallel.ring_flash import MODE_FULL

    elt = 2 if dtype_name == "bfloat16" else 4
    n, rows = B * C * H * D, B * H * C
    moved = {"fwd": 3 * n * elt + 2 * (n + 2 * rows) * 4,
             "dq": 4 * n * elt + (2 * rows + 2 * n) * 4,
             "dkv": 4 * n * elt + (2 * rows + 4 * n) * 4}[kernel]
    pairs = B * H * (C * C if mode == MODE_FULL else C * (C + 1) // 2)
    flops = {"fwd": 4, "dq": 6, "dkv": 8}[kernel] * D * pairs
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def ring_chunk_inputs(B, C, H, D, dtype, device, gen, carried: bool) -> dict:
    """One chunk round's inputs as the ring passes them: q, k, v views of
    one fused projection (q prescaled), the K4 state and the K5/K6
    accumulators after one FULL round on another K/V chunk (fresh when not
    ``carried``), do, and lse2 and delta of the forward over both chunks."""
    import torch

    from relayrl_tpu_torch.ops.flash import flash_attention_delta
    from relayrl_tpu_torch.parallel import ring_flash as rf

    q, k0, v0 = fused_qkv(B, C, H, D, dtype, device, gen)
    _, k, v = fused_qkv(B, C, H, D, dtype, device, gen)
    qs = rf.prescale_q(q)
    state = rf.chunk_fwd_plain(rf.MODE_FULL, qs, k0, v0, *rf._init_state(qs))
    both = rf.chunk_fwd_plain(rf.MODE_FULL, qs, k, v, *state)
    out, l_safe = rf._finalize_chunk_state(both[0], both[2], dtype)
    lse2 = both[1] + torch.log2(l_safe)
    do = torch.randn((B, C, H, D), generator=gen).to(device, dtype)
    delta = flash_attention_delta(out, do)
    zero = rf._zero_acc(qs)
    dq, dkv = zero, (zero, zero)
    if carried:
        dq = rf.chunk_dq_plain(rf.MODE_FULL, qs, k0, v0, do, lse2, delta, zero)
        dkv = rf.chunk_dkv_plain(rf.MODE_FULL, qs, k0, v0, do, lse2, delta, zero, zero)
    else:
        state = rf._init_state(qs)
    return {"fwd": (qs, k, v, *state), "dq": (qs, k, v, do, lse2, delta, dq),
            "dkv": (qs, k, v, do, lse2, delta, *dkv)}


def check_ring_chunks(device) -> dict:
    """K4, K5 and K6 against their plain versions: at the learner's chunk
    shape ([8, 64, 8, 32], sp 4 over T 256) in bf16 and f32, FULL and DIAG
    on a carried state and FULL on a fresh one (a non-causal ring's first
    round); at C 8, 65 (one row past K4's 64-key tile) and 128; at head
    dims 16 and 64; and at the wide head dims, [8, C, 4, 128] and [8, C, 2,
    256] chunks (C = 64 and 65), FULL and DIAG on a carried state. Times,
    bounds and plain times at the learner's shape, bf16, FULL (6 of a
    ring's 10 rounds) and DIAG, and at [8, 64, 4, 128] and [8, 64, 2, 256].
    Then the flash ring through ``ring_flash_attention_sharded`` against
    the ring of plain chunk versions, forward and gradients
    (:func:`check_padded_ring`). Returns
    {"ring_chunk_fwd": ..., ...} for bf16 FULL, each with its head dim 128
    and 256 measurements under ``"d128"`` and ``"d256"``."""
    import torch

    from relayrl_tpu_torch.parallel import ring_flash as rf

    B, H = LEARNER["traj_per_epoch"], SLICE_ARCH["n_heads"]
    D, C = SLICE_ARCH["d_model"] // H, SLICE_ARCH["max_seq_len"] // SP
    wrappers = {"fwd": rf.chunk_fwd, "dq": rf.chunk_dq, "dkv": rf.chunk_dkv}
    plains = {"fwd": rf.chunk_fwd_plain, "dq": rf.chunk_dq_plain,
              "dkv": rf.chunk_dkv_plain}
    gen = torch.Generator().manual_seed(SEED + 2)
    dtypes, modes = (torch.bfloat16, torch.float32), (rf.MODE_FULL, rf.MODE_DIAG)
    cases = [(dtype, mode, True, C, H, D) for dtype in dtypes for mode in modes]
    cases += [(dtype, rf.MODE_FULL, False, C, H, D) for dtype in dtypes]
    cases += [(dtype, mode, True, c, H, d) for dtype in dtypes for mode in modes
              for c, d in ((8, D), (65, D), (128, D), (C, 16), (C, 64))]
    cases += [(dtype, mode, True, c, h, d) for h, d in ((WIDE_H, WIDE_D), (WIDEST_H, WIDEST_D))
              for dtype in dtypes for mode in modes for c in (C, 65)]
    timed = {D: None, WIDE_D: "d128", WIDEST_D: "d256"}
    main = {f"ring_chunk_{kernel}": {} for kernel in wrappers}
    for dtype, mode, carried, c, h, d in cases:
        name = _dtype_name(dtype)
        inputs = ring_chunk_inputs(B, c, h, d, dtype, device, gen, carried)
        for kernel, args in inputs.items():
            got = wrappers[kernel](mode, *args)
            torch.cuda.synchronize()
            want = plains[kernel](mode, *args)
            got, want = ((x,) if kernel == "dq" else x for x in (got, want))
            if kernel == "fwd":
                # The state the ring finalizes: acc / l and m + log2(l).
                (o, m, l), (wo, wm, wl) = got, want
                errs = [((o / l[..., None]) - (wo / wl[..., None])).abs().max().item(),
                        ((m + torch.log2(l)) - (wm + torch.log2(wl))).abs().max().item()]
                bars = [TOLERANCE[name]] * 2
            else:
                errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
                bars = [grad_bar(dtype, w) for w in want]
            if not all(g.shape == w.shape and g.dtype == torch.float32
                       for g, w in zip(got, want)) or not all(
                           math.isfinite(e) and e <= b for e, b in zip(errs, bars)):
                raise AssertionError(
                    f"ring_chunk_{kernel} {name} mode={mode} carried={carried} "
                    f"C={c} D={d}: max abs errs {errs} above {bars}")
            line = (f"[ring] ring_chunk_{kernel} {name} mode="
                    f"{'FULL' if mode == rf.MODE_FULL else 'DIAG'} "
                    f"{'carried' if carried else 'fresh'} [{B},{c},{h},{d}] max_abs_err "
                    + "/".join(f"{e:.3e}" for e in errs) + " (tol "
                    + "/".join(f"{b:.3e}" for b in bars) + ")")
            if c == C and d in timed and carried and dtype == torch.bfloat16:
                ms = time_ms(lambda: wrappers[kernel](mode, *args))
                plain_ms = time_ms(lambda: plains[kernel](mode, *args), iters=20)
                bound_ms, bound_by = ring_chunk_bound(B, c, h, d, name, kernel, mode)
                line += (f" ms={ms:.4f} plain_ms={plain_ms:.4f} "
                         f"bound_ms={bound_ms:.4f} ({bound_by})")
                if mode == rf.MODE_FULL:
                    measured = {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
                                "bound_ms": bound_ms, "bound_by": bound_by,
                                "library_ms": None}
                    if timed[d] is None:
                        main[f"ring_chunk_{kernel}"].update(measured)
                    else:
                        main[f"ring_chunk_{kernel}"][timed[d]] = {"shape": [B, c, h, d],
                                                                  **measured}
            print(line, flush=True)
    padded = check_padded_ring(device, gen)
    for entry in main.values():
        entry["head_dims"] = sorted({case[-1] for case in cases} | set(padded))
    return main


def check_padded_ring(device, gen) -> tuple[int, ...]:
    """The causal flash ring over SP shards of the card at head dims 8, 96
    and 192 (``[8, 256, 8, 8]``, ``[8, 256, 4, 96]`` and ``[8, 256, 2,
    192]``, padded to 16, 128 and 256) and 256 (``[8, 256, 2, 256]``)
    through ``ring_flash_attention_sharded`` (the kernels: 10 launches of
    each) against the same ring through the plain chunk versions, forward
    and the gradients of ``sum(out * w)``. The last shard's K4, K5 and K6
    resume their carried state over 4 rounds (3 FULL, then DIAG): at head
    dim 256 two K4 column blocks of a row read the carried m and l and
    write the new ones, and a block that overwrote m before its twin read
    it would corrupt the twin's rescale in the next round. Returns the head
    dims."""
    import torch

    from relayrl_tpu_torch.ops.flash import KERNEL_HEAD_DIMS
    from relayrl_tpu_torch.parallel import ring_flash as rf

    B, T = LEARNER["traj_per_epoch"], SLICE_ARCH["max_seq_len"]
    C, devices = T // SP, [device] * SP
    cases = [(dtype, H, d) for H, d in ((SLICE_ARCH["n_heads"], 8), (WIDE_H, 96),
                                        (WIDEST_H, 192), (WIDEST_H, WIDEST_D))
             for dtype in (torch.bfloat16, torch.float32)]
    for dtype, H, d in cases:
        name = _dtype_name(dtype)
        q, k, v = (x.detach().requires_grad_() for x in fused_qkv(B, T, H, d, dtype, device, gen))
        w = torch.randn((B, T, H, d), generator=gen).to(device, dtype)
        shards = [[x[:, i * C:(i + 1) * C] for i in range(SP)] for x in (q, k, v)]
        before = ring_counts()
        got = torch.cat(rf.ring_flash_attention_sharded(*shards, devices), dim=1)
        got_grads = torch.autograd.grad(got, (q, k, v), w)
        torch.cuda.synchronize()
        launches = tuple(a - b for a, b in zip(ring_counts(), before))
        want = torch.cat(rf._ring_flash(*shards, devices, True, rf.PLAIN_CHUNK_CALLS), dim=1)
        want_grads = torch.autograd.grad(want, (q, k, v), w)
        errs = [(got.float() - want.float()).abs().max().item()]
        bars = [TOLERANCE[name]]
        for g, wg in zip(got_grads, want_grads):
            errs.append((g.float() - wg.float()).abs().max().item())
            bars.append(grad_bar(dtype, wg))
        pairs = SP * (SP + 1) // 2
        if (got.shape != q.shape or launches != (pairs,) * 3
                or not all(math.isfinite(e) and e <= b for e, b in zip(errs, bars))):
            raise AssertionError(f"padded ring {name} D={d}: launches {launches}, max abs "
                                 f"errs {errs} above {bars}")
        print(f"[ring] ring_flash_attention_sharded {name} causal sp={SP} [{B},{T},{H},{d}] "
              f"({'padded; ' if d not in KERNEL_HEAD_DIMS else ''}launches {launches}) vs the "
              f"plain chunk ring: max_abs_err "
              "out/dq/dk/dv " + "/".join(f"{e:.3e}" for e in errs) + " (tol "
              + "/".join(f"{b:.3e}" for b in bars) + ")", flush=True)
    return tuple(sorted({d for _, _, d in cases}))


def check_chunked_local(device) -> None:
    """``chunked_flash_local`` (K4 over every chunk pair on one device, the
    ring's cost model without transfers) against K1 on the serving shape
    and on [64, 256, 4, 128] and [64, 256, 2, 256], the wide head dims."""
    import torch

    from relayrl_tpu_torch.ops.flash import flash_attention
    from relayrl_tpu_torch.parallel.ring_flash import chunked_flash_local

    B, T = LANES, SLICE_ARCH["max_seq_len"]
    gen = torch.Generator().manual_seed(SEED + 3)
    shapes = [(SLICE_ARCH["n_heads"], SLICE_ARCH["d_model"] // SLICE_ARCH["n_heads"], (2, 4)),
              (WIDE_H, WIDE_D, (4,)), (WIDEST_H, WIDEST_D, (4,))]
    for H, D, chunks in shapes:
        q, k, v = fused_qkv(B, T, H, D, torch.bfloat16, device, gen)
        want = flash_attention(q, k, v, True)[0]
        k1_ms = time_ms(lambda: flash_attention(q, k, v, True))
        for n in chunks:
            got = chunked_flash_local(q, k, v, n)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if not (got.shape == want.shape and math.isfinite(err)
                    and err <= TOLERANCE["bfloat16"]):
                raise AssertionError(f"chunked_flash_local n={n} D={D} vs flash_fwd: {err}")
            ms = time_ms(lambda: chunked_flash_local(q, k, v, n))
            print(f"[ring] chunked_flash_local bf16 causal [{B},{T},{H},{D}] n_chunks={n} "
                  f"({n * (n + 1) // 2} K4 launches) vs flash_fwd: max abs diff "
                  f"{err:.3e} (tol {TOLERANCE['bfloat16']:g}); ms={ms:.4f}, "
                  f"flash_fwd ms={k1_ms:.4f}", flush=True)


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


def profile_device(fn, n: int, unit: str) -> dict | None:
    """Device busy share of ``n`` back-to-back calls of ``fn`` and the
    kernels that take the device time, from ``torch.profiler`` (whose own
    cost lengthens the wall time it is divided by); returns the wall and
    busy ms and the device operations per call (None when the profiler
    saw no device activity). Annotated ranges on
    the device timeline (``Optimizer.step#Adam.step``) span kernels
    counted on their own, so they are left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        print("[profile] device time: not measured (the profiler saw no "
              "device activity)")
        return None
    launches = sum(e.count for e in kernels) / n
    print(f"[profile] {n} {unit}(s): wall {wall_us / n / 1e3:.4f} ms, device "
          f"busy {busy_us / n / 1e3:.4f} ms per {unit} "
          f"({100 * busy_us / wall_us:.1f}% busy), {launches:.0f} device "
          f"operations per {unit}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[profile]   {e.self_device_time_total / n / 1e3:8.4f} ms "
              f"{100 * e.self_device_time_total / busy_us:5.1f}%  "
              f"x{e.count / n:<7.1f} {e.key[:90]}")
    return {"wall_ms": wall_us / n / 1e3, "busy_ms": busy_us / n / 1e3,
            "operations": launches}


def profile_dispatches(host, n: int = 10) -> None:
    import numpy as np

    obs = np.zeros((host.num_envs, host.arch["obs_dim"]), np.float32)
    profile_device(lambda: host.request_for_actions(obs), n, "dispatch")


def flash_counts() -> tuple[int, int, int]:
    from relayrl_tpu_torch.ops.flash import flash_attention

    return (flash_attention.launches, flash_attention.dq_launches,
            flash_attention.dkv_launches)


def zero_flash_counts() -> None:
    from relayrl_tpu_torch.ops.flash import flash_attention

    flash_attention.launches = 0
    flash_attention.dq_launches = 0
    flash_attention.dkv_launches = 0


def build_learner(device, workdir: Path, arch: dict = SLICE_ARCH):
    """The port's REINFORCE at ``arch`` (the slice's by default), on
    ``device``; the bf16 compute dtype comes from the config's
    ``learner.precision``, as in the JAX package."""
    from relayrl_tpu_torch.algorithms import build_algorithm
    from relayrl_tpu_torch.envs import RecallEnv

    workdir.mkdir(parents=True, exist_ok=True)
    config = workdir / "relayrl_config.json"
    config.write_text(json.dumps(
        {"learner": {"precision": SLICE_ARCH["precision"]}}))
    env = RecallEnv(LEARNER_HORIZON, N_CUES)
    overrides = {k: v for k, v in arch.items()
                 if k not in ("kind", "has_critic", "precision")}
    algo = build_algorithm(
        "REINFORCE", env_dir=str(workdir), config_path=str(config),
        obs_dim=int(env.observation_space.shape[0]),
        act_dim=int(env.action_space.n), device=device,
        model_kind=arch["kind"], seed=SEED, seed_salt=0,
        **overrides, **LEARNER)
    for key, value in arch.items():
        if algo.arch[key] != value:
            raise AssertionError(f"learner arch {key}={algo.arch[key]!r}, "
                                 f"expected {value!r}")
    return algo


def compare_update(algo, params0, batch, device, plain_attn, wrap=None) -> dict:
    """The learner's first update through the kernels against the same
    update with every block's attention replaced by ``plain_attn`` (which
    runs the kernels' plain versions), both from ``params0`` with fresh
    Adam state; ``wrap`` wraps the update (the sharded update of phase 7).
    Returns the largest metric and parameter differences."""
    import torch

    from relayrl_tpu_torch.algorithms.onpolicy import read_metrics
    from relayrl_tpu_torch.algorithms.reinforce import (
        ReinforceState,
        make_optimizers,
        make_reinforce_update,
    )

    update = make_reinforce_update(algo.policy, algo.train_vf_iters,
                                   algo.gamma, algo.lam, algo.with_baseline)
    if wrap is not None:
        update = wrap(update)
    sides = {}
    for side in ("kernel", "plain"):
        params = copy.deepcopy(params0)
        if side == "plain":
            for block in params.blocks():
                block.attn_fn = plain_attn
        state = ReinforceState(params, *make_optimizers(params, algo.pi_lr, algo.vf_lr))
        state, metrics = update(state, {key: torch.as_tensor(val, device=device)
                                        for key, val in batch.items()})
        sides[side] = (dict(state.params.named_parameters()), read_metrics(metrics))
    (got, got_m), (want, want_m) = sides["kernel"], sides["plain"]
    metric_err = 0.0
    for key, value in want_m.items():
        err = abs(got_m[key] - value)
        if not err <= UPDATE_METRIC_TOL * max(1.0, abs(value)):
            raise AssertionError(f"update metric {key}: kernel {got_m[key]} vs "
                                 f"plain {value}")
        metric_err = max(metric_err, err)
    start = dict(params0.named_parameters())
    diff_sum = moved_sum = 0.0
    param_err = 0.0
    for name, w in want.items():
        steps = algo.train_vf_iters if name.startswith("vf") else 1
        bound = 2 * steps * (algo.vf_lr if name.startswith("vf") else algo.pi_lr)
        err = (got[name] - w).abs().max().item()
        if not err <= bound:
            raise AssertionError(f"update param {name}: kernel vs plain {err} "
                                 f"above {bound}")
        param_err = max(param_err, err)
        diff_sum += (got[name] - w).abs().mean().item()
        moved_sum += (w - start[name]).abs().mean().item()
    share = diff_sum / moved_sum
    if not share <= UPDATE_MEAN_DIFF_SHARE:
        raise AssertionError(f"update params: mean |kernel - plain| is "
                             f"{share:.4f} of the mean movement")
    return {"metric_err": metric_err, "param_err": param_err,
            "mean_diff_share": share}


def epoch_batches(algo, episodes, n: int) -> list[dict]:
    """The first ``n`` epoch batches of ``episodes``, padded by an
    ``EpochBuffer`` as the learner pads them."""
    import numpy as np

    from relayrl_tpu_torch.data import EpochBuffer

    per = algo.traj_per_epoch
    batches = []
    for i in range(n):
        buf = EpochBuffer(algo.obs_dim, algo.act_dim, per, buckets=algo.buffer.buckets)
        for records in episodes[i * per:(i + 1) * per]:
            buf.add_episode(records)
        batches.append({k: np.array(v) for k, v in buf.drain().as_dict().items()})
    return batches


def learn(device, workdir: Path) -> dict:
    """Drive the learner slice: actors serve from the learner's bundle,
    every shipped episode goes to ``receive_trajectory``, and the host
    swaps to each new bundle. Checks counts, versions, metrics and params.
    Returns the launch counts, the update times, the algorithm, the first
    epoch's batch and the first wave's episodes."""
    import torch

    from relayrl_tpu_torch.algorithms.onpolicy import read_metrics
    from relayrl_tpu_torch.envs import RecallEnv, SyncVectorEnv
    from relayrl_tpu_torch.runtime.vector_actor import (
        VectorActorHost,
        run_vector_gym_loop,
    )
    from relayrl_tpu_torch.types import deserialize_actions

    from relayrl_tpu_torch.ops.flash import flash_attention

    algo = build_learner(device, workdir)
    params0 = copy.deepcopy(algo.state.params)
    flash_attention.do_copies = 0
    sent = []
    host = VectorActorHost(algo.bundle(), LANES, on_send=lambda lane, p: sent.append(p),
                           seed=SEED, device=device)
    venv = SyncVectorEnv([lambda: RecallEnv(LEARNER_HORIZON, N_CUES)] * LANES)
    per_update, seconds, kls, first_batch = [], [], [], None
    for wave in range(LEARNER_WAVES):
        sent.clear()
        run_vector_gym_loop(host, venv, LEARNER_HORIZON, seed=SEED + wave)
        if len(sent) != LANES:
            raise AssertionError(f"wave {wave}: {len(sent)} episodes shipped")
        episodes = [deserialize_actions(p) for p in sent]
        if first_batch is None:
            # The first epoch's batch, assembled apart for compare_update.
            first_batch = epoch_batches(algo, episodes, 1)[0]
            first_wave = episodes
        for records in episodes:
            if len(records) != LEARNER_HORIZON + 1 or not records[-1].done:
                raise AssertionError(f"shipped episode of {len(records)} records")
            zero_flash_counts()
            t0 = time.perf_counter()
            updated = algo.receive_trajectory(records)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            counts = flash_counts()
            if not updated:
                if counts != (0, 0, 0):
                    raise AssertionError(f"launches {counts} without an update")
                continue
            per_update.append(counts)
            seconds.append(elapsed)
            kls.append(read_metrics(algo._last_metrics)["KL"])
            if not host.maybe_swap(algo.bundle()):
                raise AssertionError(f"hot swap to version {algo.version} refused")
    n_layers = SLICE_ARCH["n_layers"]
    evaluates = 4 + LEARNER["train_vf_iters"]
    expected = (n_layers * evaluates, n_layers, n_layers)
    updates = LEARNER_WAVES * LANES // LEARNER["traj_per_epoch"]
    if len(per_update) != updates or any(c != expected for c in per_update):
        raise AssertionError(f"launches per update {per_update}; expected "
                             f"{updates} x {expected}")
    if not algo.version == host.version == updates:
        raise AssertionError(f"versions: learner {algo.version}, host {host.version}")
    per_wave = updates // LEARNER_WAVES
    on_policy = kls[::per_wave]
    if not all(abs(kl) <= ON_POLICY_KL_TOL for kl in on_policy):
        raise AssertionError(f"KL of the first update of each wave {on_policy}: "
                             f"learner and actors disagree on the same params")
    metrics = read_metrics(algo._last_metrics)
    if len(metrics) != 8 or not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"metrics {metrics}")
    if getattr(algo, "freeze_info", None) is not None:
        raise AssertionError(f"frozen leaves {algo.freeze_info}")
    start = dict(params0.named_parameters())
    for name, param in algo.state.params.named_parameters():
        if not torch.isfinite(param).all() or torch.equal(param, start[name]):
            raise AssertionError(f"param {name} not finite or unchanged")
    return {"algo": algo, "params0": params0, "batch": first_batch,
            "first_wave": first_wave,
            "do_copies": flash_attention.do_copies, "on_policy_kl": on_policy,
            "per_update": per_update, "seconds": seconds, "metrics": metrics,
            "launches": tuple(sum(c[i] for c in per_update) for i in range(3))}


def ring_counts() -> tuple[int, int, int]:
    from relayrl_tpu_torch.parallel import ring_flash as rf

    return rf.chunk_fwd.launches, rf.chunk_dq.launches, rf.chunk_dkv.launches


def zero_ring_counts() -> None:
    from relayrl_tpu_torch.parallel import ring_flash as rf

    rf.chunk_fwd.launches = rf.chunk_dq.launches = rf.chunk_dkv.launches = 0


def learn_sp(device, workdir: Path, learned: dict) -> dict:
    """Drive the sequence-parallel learner: REINFORCE at the slice's arch
    with ``attention="ring"``, its update run by ``make_sharded_update(...,
    shard_time=True)`` over an sp mesh of ``SP`` shards of the one card,
    for ``SP_UPDATES`` updates on epoch batches of phase 5's first wave,
    which the actors drew from the initial params this learner starts
    from. Checks the launch counts of every update, the first update's KL,
    the metrics and the params."""
    import torch

    from relayrl_tpu_torch.algorithms.onpolicy import read_metrics
    from relayrl_tpu_torch.algorithms.reinforce import make_reinforce_update
    from relayrl_tpu_torch.parallel import make_mesh, make_sharded_update, place_state

    algo = build_learner(device, workdir, {**SLICE_ARCH, "attention": "ring"})
    params0 = copy.deepcopy(algo.state.params)
    for (name, p), q in zip(params0.named_parameters(), learned["params0"].parameters()):
        if not torch.equal(p, q):
            raise AssertionError(f"initial {name} differs from the flash learner's")
    mesh = make_mesh({"sp": SP}, [device] * SP)
    update = make_reinforce_update(algo.policy, algo.train_vf_iters, algo.gamma,
                                   algo.lam, algo.with_baseline)
    sharded = make_sharded_update(update, mesh, algo.state, shard_time=True)
    state = place_state(algo.state, mesh)
    batches = epoch_batches(algo, learned["first_wave"], SP_UPDATES)
    per_update, seconds, metrics = [], [], []
    for batch in batches:
        zero_flash_counts()
        zero_ring_counts()
        t0 = time.perf_counter()
        state, out = sharded(state, batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        per_update.append(flash_counts() + ring_counts())
        metrics.append(read_metrics(out))
    n_layers = SLICE_ARCH["n_layers"]
    pairs = SP * (SP + 1) // 2  # causal: shard i attends chunks 0..i
    evaluates = 4 + LEARNER["train_vf_iters"]
    expected = (0, 0, 0, evaluates * n_layers * pairs, n_layers * pairs,
                n_layers * pairs)
    if any(c != expected for c in per_update):
        raise AssertionError(f"launches per update {per_update}; expected {expected}")
    if state.step != SP_UPDATES:
        raise AssertionError(f"sp learner at step {state.step}")
    if not abs(metrics[0]["KL"]) <= ON_POLICY_KL_TOL:
        raise AssertionError(f"KL of the first sp update {metrics[0]['KL']}: the "
                             f"ring learner and the actors disagree on the same params")
    for m in metrics:
        if len(m) != 8 or not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"sp metrics {m}")
    start = dict(params0.named_parameters())
    for name, param in state.params.named_parameters():
        if not torch.isfinite(param).all() or torch.equal(param, start[name]):
            raise AssertionError(f"sp param {name} not finite or unchanged")
    return {"algo": algo, "mesh": mesh, "sharded": sharded, "state": state,
            "params0": params0, "batches": batches, "per_update": per_update,
            "seconds": seconds, "metrics": metrics,
            "launches": tuple(sum(c[i] for c in per_update) for i in range(6))}


def compare_ring_evaluate(algo, params, mesh, device) -> float:
    """``evaluate`` at ``[LANES, max_seq_len]`` through the ring (under the
    sp mesh) against the same params through K1; returns the max abs
    difference over (logp, entropy, v)."""
    import torch

    from relayrl_tpu_torch.ops.flash import flash_attention
    from relayrl_tpu_torch.parallel import use_mesh

    gen = torch.Generator().manual_seed(SEED + 4)
    obs = torch.randn((LANES, SLICE_ARCH["max_seq_len"], algo.obs_dim),
                      generator=gen).to(device)
    act = torch.randint(0, algo.act_dim, obs.shape[:2], generator=gen).to(device)
    flash = copy.deepcopy(params)
    for block in flash.blocks():
        block.attn_fn = lambda q, k, v: flash_attention(q, k, v, True)[0]
    with torch.inference_mode():
        with use_mesh(mesh):
            got = algo.policy.evaluate(params, obs, act)
        want = algo.policy.evaluate(flash, obs, act)
    return max((a - b).abs().max().item() for a, b in zip(got, want))


def check_wide_transformer(device, workdir: Path, arch: dict) -> dict:
    """A transformer at a wide head dim (``WIDE_ARCH``: d_model 512, 4 heads
    of 128; ``WIDEST_ARCH``: d_model 1024, 4 heads of 256; 2 layers, T 256,
    bf16, flash attention) builds on the card and trains: 8 port actors
    serve one wave of ``RecallEnv(255)`` episodes from its learner's
    bundle; ``evaluate`` through K1 matches the plain attention (phase 4's
    bar), and the learner's first update through K1-K3 matches the same
    update through the plain attention (phase 5's bars), launching n_layers
    x 84 K1 and n_layers K2 and K3."""
    import torch

    from relayrl_tpu_torch.envs import RecallEnv, SyncVectorEnv
    from relayrl_tpu_torch.ops.flash import flash_attention_plain
    from relayrl_tpu_torch.runtime.vector_actor import VectorActorHost, run_vector_gym_loop
    from relayrl_tpu_torch.types import deserialize_actions

    algo = build_learner(device, workdir, arch)
    params0 = copy.deepcopy(algo.state.params)
    lanes = algo.traj_per_epoch
    sent = []
    host = VectorActorHost(algo.bundle(), lanes, on_send=lambda lane, p: sent.append(p),
                           seed=SEED, device=device)
    run_vector_gym_loop(host, SyncVectorEnv([lambda: RecallEnv(LEARNER_HORIZON, N_CUES)] * lanes),
                        LEARNER_HORIZON, seed=SEED)
    episodes = [deserialize_actions(p) for p in sent]
    if len(episodes) != lanes or any(len(r) != LEARNER_HORIZON + 1 for r in episodes):
        raise AssertionError(f"{len(episodes)} wide episodes shipped")
    eval_err = compare_evaluate(host, device)
    if not eval_err <= TOLERANCE["bfloat16"]:
        raise AssertionError(f"wide evaluate kernel vs plain attention: {eval_err}")
    zero_flash_counts()
    cmp = compare_update(algo, params0, epoch_batches(algo, episodes, 1)[0], device,
                         lambda q, k, v: flash_attention_plain(q, k, v, True)[0])
    torch.cuda.synchronize()
    launches = flash_counts()
    n_layers = arch["n_layers"]
    expected = (n_layers * (4 + algo.train_vf_iters), n_layers, n_layers)
    if launches != expected:
        raise AssertionError(f"wide update launches {launches}, expected {expected}")
    return {"evaluate_err": eval_err, "launches": launches, **cmp}


def _spy_calls(actor, name: str, logits: list | None = None) -> list:
    """Replaces the actor's ``name`` function (``_cached_fn``,
    ``_window_fn``, ``_prefill_fn``) with a wrapper that appends one entry
    per call to the returned list; with ``logits``, each call's readout
    logits (the last row of the model's logits, f32) are appended there."""
    fn, calls = getattr(actor, name), []

    def keep(module, inputs, out):
        # Readout mode returns (logits, v); decode mode ((logits, v), cache).
        rows = out[0][0] if isinstance(out[0], tuple) else out[0]
        logits.append(rows.detach().float().reshape(-1, rows.shape[-1])[-1])

    def spy(params, *args):
        calls.append(None)
        if logits is None:
            return fn(params, *args)
        handle = params.register_forward_hook(keep)
        try:
            return fn(params, *args)
        finally:
            handle.remove()

    setattr(actor, name, spy)
    return calls


def check_cached_decode(device) -> dict:
    """The transformer's KV-cache decode path on the card, at the serving
    slice's arch (``__graft_entry__.entry()``'s: d_model 256, 4 layers, 8
    heads, T 256, bf16): a ``PolicyActor`` serving through the cache and one
    serving through the window, from one bundle and seed, act on the same
    ``CACHED_EPISODES`` ``RecallEnv(HORIZON)`` episodes (longer than the
    window, so it rolls), with a hot swap at step ``CACHED_SWAP_AT`` of the
    first. Before the window rolls, at every position, the cached step's
    log-probability of a fixed action and its v match the window step's at
    the bf16 bar (3e-2 of the largest |value|); the swap costs exactly one
    prefill; the cached path launches no flash kernel (the window path n_layers
    - 1 per step) and serves every step until the window rolls, the window
    path after. Returns the errors, the actions' agreement rate and the ms
    per env step of both paths."""
    import numpy as np
    import torch

    from relayrl_tpu_torch.envs import RecallEnv
    from relayrl_tpu_torch.models import build_policy
    from relayrl_tpu_torch.runtime import PolicyActor
    from relayrl_tpu_torch.types import ModelBundle
    from relayrl_tpu_torch.weights import params_to_jax

    arch = slice_arch()
    policy = build_policy(arch, device)
    v1, v2 = (ModelBundle(version, arch, params_to_jax(policy.init_params(
        torch.Generator().manual_seed(SEED + version)))) for version in (1, 2))
    actors = {side: PolicyActor(v1, seed=SEED, device=device, use_kv_cache=side == "cached")
              for side in ("cached", "window")}
    cached = actors["cached"]
    logits = {side: [] for side in actors}
    steps = _spy_calls(cached, "_cached_fn", logits["cached"])
    window_steps = _spy_calls(cached, "_window_fn")
    prefills = _spy_calls(cached, "_prefill_fn")
    _spy_calls(actors["window"], "_window_fn", logits["window"])
    context = arch["max_seq_len"]
    env = RecallEnv(HORIZON, N_CUES)
    n_layers = arch["n_layers"]
    fixed = 0  # the action whose log-probability is compared
    diffs = {"logp": [], "v": []}
    wants = {"logp": [], "v": []}
    seconds = {side: 0.0 for side in actors}
    agree = compared = total_k1 = 0
    for episode in range(CACHED_EPISODES):
        obs, _ = env.reset(seed=SEED + episode)
        for t in range(HORIZON):
            if episode == 0 and t == CACHED_SWAP_AT:
                n_prefills = len(prefills)
                if not all(actor.maybe_swap(v2) for actor in actors.values()):
                    raise AssertionError("hot swap refused")
            records = {}
            for side, actor in actors.items():
                zero_flash_counts()
                t0 = time.perf_counter()
                records[side] = actor.request_for_action(obs)
                torch.cuda.synchronize()
                elapsed = time.perf_counter() - t0
                launches = flash_counts()
                total_k1 += launches[0]
                want = (0 if side == "cached" and t < context else n_layers - 1, 0, 0)
                if launches != want:
                    raise AssertionError(f"{side} step {t}: flash launches {launches}, "
                                         f"expected {want}")
                if t < context:
                    seconds[side] += elapsed
            if episode == 0 and t == CACHED_SWAP_AT and len(prefills) != n_prefills + 1:
                raise AssertionError(f"{len(prefills) - n_prefills} prefills after the swap")
            if t < context:
                got_l, want_l = logits["cached"][-1], logits["window"][-1]
                diffs["logp"].append(abs(torch.log_softmax(got_l, -1)[fixed]
                                         - torch.log_softmax(want_l, -1)[fixed]).item())
                wants["logp"].append(abs(torch.log_softmax(want_l, -1)[fixed].item()))
                got_v, want_v = (float(records[s].data["v"]) for s in ("cached", "window"))
                diffs["v"].append(abs(got_v - want_v))
                wants["v"].append(abs(want_v))
                compared += 1
                agree += int(records["cached"].act) == int(records["window"].act)
            obs, reward, terminated, truncated, _ = env.step(int(records["cached"].act))
        for actor in actors.values():
            actor.flag_last_action(reward)
    errs = {key: max(diffs[key]) for key in diffs}
    bars = {key: TOLERANCE["bfloat16"] * max(wants[key]) for key in wants}
    rolled = CACHED_EPISODES * (HORIZON - context)
    if not all(math.isfinite(errs[key]) and errs[key] <= bars[key] for key in errs):
        raise AssertionError(f"cached vs window step: max abs errs {errs} above {bars}")
    if (len(steps) != CACHED_EPISODES * context or len(window_steps) != rolled
            or len(prefills) != 1):
        raise AssertionError(f"cached steps {len(steps)}, window steps {len(window_steps)}, "
                             f"prefills {len(prefills)}")
    return {"errs": errs, "bars": bars, "agreement": agree / compared, "compared": compared,
            "prefills": len(prefills), "cached_ms": 1e3 * seconds["cached"] / compared,
            "window_ms": 1e3 * seconds["window"] / compared, "launches": total_k1}


def _local_config(workdir: Path, precision: str = "float32") -> str:
    workdir.mkdir(parents=True, exist_ok=True)
    config = workdir / "relayrl_config.json"
    config.write_text(json.dumps({"learner": {"precision": precision}}))
    return str(config)


def _spy_updates(runner, on_update) -> list:
    """Wraps the runner's learner ingest: ``on_update(actions, counts)``
    after each update, with the flash launch counts it made; every episode
    it took is appended to the returned list."""
    import torch

    seen = []
    ingest = runner.algorithm.receive_trajectory

    def receive(actions):
        seen.append(actions)
        before = flash_counts()
        updated = ingest(actions)
        torch.cuda.synchronize()
        counts = tuple(a - b for a, b in zip(flash_counts(), before))
        if updated:
            on_update(actions, counts)
        elif counts != (0, 0, 0):
            raise AssertionError(f"launches {counts} without an update")
        return updated

    runner.algorithm.receive_trajectory = receive
    return seen


def local_cartpole(device, workdir: Path) -> dict:
    """``LocalRunner`` on CartPole-v1 (``mlp_discrete``, the
    cartpole_reinforce_baseline golden's hyperparameters) for
    ``LOCAL_UPDATES`` updates on the card: learner, actor and runner
    versions advance together, episodes cross the wire codec, no flash
    kernel runs. Then the learner's first update, from its initial params
    on its first epoch's batch, on the card against the same update on the
    CPU (f32, TF32 off; :func:`compare_update_to_cpu`)."""
    import torch

    from relayrl_tpu_torch.envs import make
    from relayrl_tpu_torch.runtime import LocalRunner

    runner = LocalRunner(make("CartPole-v1"), "REINFORCE", config_path=_local_config(workdir),
                         env_dir=str(workdir), seed=1, device=device, **CARTPOLE_HP)
    algo = runner.algorithm
    if algo.arch["kind"] != "mlp_discrete" or runner.actor.policy.device != device:
        raise AssertionError(f"CartPole learner {algo.arch['kind']} on "
                             f"{runner.actor.policy.device}")
    params0 = copy.deepcopy(algo.state.params)
    versions = []
    episodes = _spy_updates(runner, lambda actions, counts: versions.append(
        (algo.version, counts)))
    zero_flash_counts()
    t0 = time.perf_counter()
    result = runner.train(epochs=LOCAL_UPDATES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = runner.actor.steps_served
    if (runner.updates != LOCAL_UPDATES or algo.version != LOCAL_UPDATES
            or runner.actor.version != LOCAL_UPDATES
            or [v for v, _ in versions] != list(range(1, LOCAL_UPDATES + 1))
            or flash_counts() != (0, 0, 0)
            or not all(math.isfinite(r) for r in result["returns"])):
        raise AssertionError(f"CartPole loop: updates {runner.updates}, versions {versions}, "
                             f"actor {runner.actor.version}, flash launches {flash_counts()}")

    cmp = compare_update_to_cpu(algo, params0, epoch_batches(algo, episodes, 1)[0])
    return {"wall": wall, "steps": steps, "updates": runner.updates,
            "avg_return": result["avg_return_last_window"], **cmp}


def compare_update_to_cpu(algo, params0, batch) -> dict:
    """The learner's update from ``params0`` on ``batch`` on its device
    against the same update on the CPU, both with fresh Adam state, in f32:
    metrics within ``MLP_METRIC_RTOL`` plus ``MLP_METRIC_ATOL``, every
    parameter element within ``MLP_PARAM_ATOL``, except where both sides
    take Adam's normalized step on rounding noise, held to Adam's step
    bound, the learning rate per step taken: a transformer's qkv bias (the
    key third of its gradient is zero in exact arithmetic: a softmax does
    not change when one constant is added to all of a query's scores;
    tests/test_torch_reinforce.py holds the JAX package the same way), and
    every element whose RMS gradient on the CPU fell below ``ADAM_FLOOR``
    at some step. Returns the largest differences, the elements below the
    floor and the largest difference among them."""
    import torch

    from relayrl_tpu_torch.algorithms.onpolicy import read_metrics
    from relayrl_tpu_torch.algorithms.reinforce import (
        ReinforceState,
        make_optimizers,
        make_reinforce_update,
    )
    from relayrl_tpu_torch.models import build_policy
    from relayrl_tpu_torch.weights import params_to_jax

    sides = {}
    least_rms = {}  # the CPU side's smallest sqrt(v_hat) per element over its steps

    def track_rms(opt, args, kwargs):
        beta2 = opt.param_groups[0]["betas"][1]
        for p, st in opt.state.items():
            rms = st["exp_avg_sq"].sqrt() / math.sqrt(1 - beta2 ** float(st["step"]))
            least_rms[p] = torch.minimum(least_rms[p], rms) if p in least_rms else rms

    for side in ("card", "cpu"):
        policy = algo.policy if side == "card" else build_policy(algo.arch, "cpu")
        params = policy.load_params(params_to_jax(params0))
        state = ReinforceState(params, *make_optimizers(params, algo.pi_lr, algo.vf_lr))
        opts = [opt for opt in (state.pi_opt, state.vf_opt) if opt is not None]
        if side == "cpu":
            for opt in opts:
                opt.register_step_post_hook(track_rms)
        update = make_reinforce_update(policy, algo.train_vf_iters, algo.gamma, algo.lam,
                                       algo.with_baseline)
        state, metrics = update(state, {k: torch.as_tensor(v, device=policy.device)
                                        for k, v in batch.items()})
        sides[side] = ({name: p.detach().cpu() for name, p in state.params.named_parameters()},
                       read_metrics(metrics))
    (got, got_m), (want, want_m) = sides["card"], sides["cpu"]
    # Adam's step bound per parameter: its learning rate times its steps.
    step_bound = {p: opt.param_groups[0]["lr"] * float(opt.state[p]["step"])
                  for opt in opts for p in opt.param_groups[0]["params"]}
    metric_err = param_err = floor_err = 0.0
    n_floored = 0
    for key, value in want_m.items():
        err = abs(got_m[key] - value)
        if not err <= MLP_METRIC_RTOL * abs(value) + MLP_METRIC_ATOL:
            raise AssertionError(f"update metric {key}: card {got_m[key]} vs cpu {value}")
        metric_err = max(metric_err, err)
    for name, p in state.params.named_parameters():
        diff = (got[name] - want[name]).abs()
        if name.endswith("qkv.bias"):
            noise = torch.ones_like(diff, dtype=torch.bool)
            bound = torch.full_like(diff, algo.pi_lr)
        else:
            noise = least_rms[p] < ADAM_FLOOR
            bound = torch.where(noise, step_bound[p], MLP_PARAM_ATOL)
        if not bool((diff <= bound).all()):
            i = int((diff - bound).argmax())
            raise AssertionError(f"update param {name}: card vs cpu {diff.flatten()[i].item()} "
                                 f"above {bound.flatten()[i].item()} at element {i}")
        if not name.endswith("qkv.bias"):
            param_err = max(param_err, diff.where(~noise, 0.0).max().item())
            floor_err = max(floor_err, diff.where(noise, 0.0).max().item())
            n_floored += int(noise.sum())
    return {"metric_err": metric_err, "param_err": param_err, "n_floored": n_floored,
            "floor_err": floor_err}


def local_recall(device, workdir: Path) -> dict:
    """``LocalRunner`` on ``RecallEnv(horizon=8)`` with the
    recall_transformer golden's flash transformer (d_model 32, 2 heads:
    head dim 16) for ``RECALL_UPDATES`` updates on the card. The flash
    counts are 0 before the runner is built and read after: each update
    launches n_layers x (4 + train_vf_iters) K1 and n_layers K2 and K3, and
    every K1 launch of the run is accounted for: one per layer for the
    actor's validation and the updates'. The actor serves every env step
    through its KV cache (the episodes never fill the window), which runs
    no K1; a step through the window path would launch one per layer but
    the last (the readout layer attends for one row, without K1). Then the
    first update on the card against the same update on the CPU (f32;
    :func:`compare_update_to_cpu`)."""
    import torch

    from relayrl_tpu_torch.envs import RecallEnv
    from relayrl_tpu_torch.examples.train_memory import recall_hyperparams
    from relayrl_tpu_torch.runtime import LocalRunner

    hp = recall_hyperparams("transformer", RECALL_HORIZON, "flash")
    zero_flash_counts()
    runner = LocalRunner(RecallEnv(horizon=RECALL_HORIZON), "REINFORCE",
                         config_path=_local_config(workdir), env_dir=str(workdir), seed=0,
                         device=device, **hp)
    params0 = copy.deepcopy(runner.algorithm.state.params)
    per_update = []
    episodes = _spy_updates(runner, lambda actions, counts: per_update.append(counts))
    cached_steps = _spy_calls(runner.actor, "_cached_fn")
    window_steps = _spy_calls(runner.actor, "_window_fn")
    result = runner.train(epochs=RECALL_UPDATES)
    torch.cuda.synchronize()
    launches = flash_counts()
    n_layers = hp["n_layers"]
    expected = (n_layers * (4 + hp["train_vf_iters"]), n_layers, n_layers)
    steps = runner.actor.steps_served
    total_k1 = n_layers + (n_layers - 1) * len(window_steps) + RECALL_UPDATES * expected[0]
    if (per_update != [expected] * RECALL_UPDATES
            or launches != (total_k1, RECALL_UPDATES * n_layers, RECALL_UPDATES * n_layers)
            or len(cached_steps) != steps or runner.actor.version != RECALL_UPDATES):
        raise AssertionError(f"recall loop: launches per update {per_update} (expected "
                             f"{expected}), total {launches} (expected K1 {total_k1}), "
                             f"cached steps {len(cached_steps)} of {steps}, actor version "
                             f"{runner.actor.version}")
    cmp = compare_update_to_cpu(runner.algorithm, params0,
                                epoch_batches(runner.algorithm, episodes, 1)[0])
    return {"per_update": per_update, "launches": launches, "steps": steps,
            "cached_steps": len(cached_steps),
            "head_dim": hp["d_model"] // hp["n_heads"], "episodes": len(result["returns"]),
            "avg_return": result["avg_return_last_window"], **cmp}


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class ChaosServer:
    """The port's ``examples/chaos_server.py`` in a process of its own,
    started with ``subprocess`` (never a fork of this CUDA process), its
    output kept in ``log``; :meth:`status` reads its status file."""

    def __init__(self, root: Path, cfg: dict, log: Path):
        import os

        self.cfg, self.log = cfg, log
        env = dict(os.environ, PYTHONPATH=str(root))
        self._out = open(log, "ab")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "relayrl_tpu_torch.examples.chaos_server",
             json.dumps(cfg)], cwd=str(root), env=env, stdout=self._out,
            stderr=subprocess.STDOUT)

    def status(self) -> dict | None:
        """This process's last status (None before its first write: a
        killed predecessor's file is not this one's)."""
        try:
            status = json.loads(Path(self.cfg["status_path"]).read_text())
        except (OSError, ValueError):
            return None
        return status if status.get("pid") == self.proc.pid else None

    def wait(self, pred, what: str, timeout_s: float = DIST_TIMEOUT_S,
             poll=None) -> dict:
        """Poll the status file until ``pred(status)``; ``poll`` runs
        between reads (the agent's env loop, say)."""
        deadline = time.monotonic() + timeout_s
        status = None
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise AssertionError(
                    f"chaos server exited ({self.proc.returncode}) waiting "
                    f"for {what}:\n{self.tail()}")
            status = self.status()
            if status is not None and pred(status):
                return status
            if poll is not None:
                poll()
            else:
                time.sleep(0.2)
        raise AssertionError(f"timed out waiting for {what}; last status "
                             f"{status and {k: status[k] for k in ('version', 'stats')}}"
                             f"\n{self.tail()}")

    def tail(self, n: int = 4000) -> str:
        self._out.flush()
        return self.log.read_bytes()[-n:].decode(errors="replace")

    def stop(self, sig=None) -> None:
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(sig or signal.SIGTERM)
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)
        self._out.close()


def check_clean_guardrails(status: dict) -> None:
    """A clean run under the default guardrails: probes live, nothing
    rejected, struck or quarantined, no watchdog trip, no rollback."""
    guard = status["guardrails"]
    quarantine = guard.get("quarantine") or {}
    watchdog = guard.get("watchdog") or {}
    if (not guard or status["probes_disabled"]
            or guard["validation_mode"] != "enforce"
            or quarantine.get("quarantines_total")
            or quarantine.get("strikes_pending")
            or watchdog.get("trips_total") or guard["rollbacks_total"]
            or guard["halted"]):
        raise AssertionError(f"guardrails on a clean run: {guard}, probes "
                             f"disabled {status['probes_disabled']}")


def distributed_loop(device, root: Path, workdir: Path) -> dict:
    """Phase 11: the flagship learner trained across two processes on the
    card through the port's TrainingServer and VectorAgent over ZMQ, then
    the learner SIGKILL drill. Checks the ingest accounting, the learner
    errors, the server's K1/K2/K3 launches per update, the agent's K1
    launches per dispatch, the bit-identity of the agent's params with the
    server's publish, and the drill's accounting and version continuity."""
    import shutil
    import signal

    from relayrl_tpu_torch.checkpoint.manager import (
        CheckpointManager,
        train_state_digest,
    )
    from relayrl_tpu_torch.envs import RecallEnv, SyncVectorEnv
    from relayrl_tpu_torch.runtime.agent import VectorAgent
    from relayrl_tpu_torch.runtime.vector_actor import run_vector_gym_loop
    from relayrl_tpu_torch.weights import params_to_jax, tree_digest

    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    ports = [_free_port() for _ in range(3)]
    server_addrs = {"agent_listener_addr": f"tcp://127.0.0.1:{ports[0]}",
                    "trajectory_addr": f"tcp://127.0.0.1:{ports[1]}",
                    "model_pub_addr": f"tcp://127.0.0.1:{ports[2]}"}
    agent_addrs = {"agent_listener_addr": server_addrs["agent_listener_addr"],
                   "trajectory_addr": server_addrs["trajectory_addr"],
                   "model_sub_addr": server_addrs["model_pub_addr"]}
    env = RecallEnv(LEARNER_HORIZON, N_CUES)
    arch = SLICE_ARCH
    hyperparams = {"model_kind": arch["kind"], "seed": SEED, "seed_salt": 0,
                   **{k: v for k, v in arch.items()
                      if k not in ("kind", "has_critic", "precision")},
                   **LEARNER}
    scratch = workdir / "server"
    cfg = {"algorithm": "REINFORCE",
           "obs_dim": int(env.observation_space.shape[0]),
           "act_dim": int(env.action_space.n), "hyperparams": hyperparams,
           "device": str(device), "scratch": str(scratch), "checkpoint_every": 1,
           "config": {"learner": {"precision": arch["precision"]}},
           "digests": True, "status_path": str(workdir / "status.json"),
           "profile": {"after": 1, "updates": DIST_UPDATES - 1,
                       "path": str(workdir / "profile.json")},
           **server_addrs}
    # The reference's default config: guardrails on.
    agent_config = workdir / "agent_config.json"
    agent_config.write_text(json.dumps({}))
    n_layers = arch["n_layers"]
    per_update = (n_layers * (4 + LEARNER["train_vf_iters"]), n_layers, n_layers)

    server = ChaosServer(root, cfg, workdir / "server.log")
    agent = None
    try:
        server.wait(lambda s: True, "the server to come up")
        agent = VectorAgent(num_envs=DIST_LANES, config_path=str(agent_config),
                            seed=SEED, probe=False, device=device,
                            model_path=str(workdir / "client_model.rlx"),
                            **agent_addrs)
        venv = SyncVectorEnv([lambda: RecallEnv(LEARNER_HORIZON, N_CUES)]
                             * DIST_LANES)
        waves = 0

        def wave():
            nonlocal waves
            run_vector_gym_loop(agent, venv, LEARNER_HORIZON, seed=SEED + waves)
            waves += 1

        # Train: DIST_UPDATES waves, one epoch each.
        zero_flash_counts()
        dispatches0 = agent.host.dispatches
        t0 = time.perf_counter()
        for _ in range(DIST_UPDATES):
            wave()
        wall = time.perf_counter() - t0
        dispatches = agent.host.dispatches - dispatches0
        agent_counts = flash_counts()
        status = server.wait(
            lambda s: (s["stats"]["updates"] == DIST_UPDATES
                       and s["version"] == DIST_UPDATES
                       and agent.model_version == DIST_UPDATES
                       and (s.get("published") or {}).get("version")
                       == DIST_UPDATES),
            f"{DIST_UPDATES} updates published and installed")
        # The digest of what the agent holds, read under its swap lock.
        with agent.host._lock:
            agent_version = agent.host.version
            agent_digest = tree_digest(params_to_jax(agent.host.params))
        decoder = agent.host._wire_decoder
        lane_ids = list(agent.agent_ids)
        sent = agent.spool.sent_counts()

        # Gates after training.
        stats = status["stats"]
        if stats["learner_errors"] or stats["dropped"] or stats["publish_errors"]:
            raise AssertionError(f"server stats {stats}: "
                                 f"{status['last_learner_error']}")
        check_clean_guardrails(status)
        for lane in lane_ids:
            row = status["accounting"]["agents"].get(lane)
            if row != {"max_seq": sent[lane], "accepted": sent[lane],
                       "contiguous": True}:
                raise AssertionError(f"ingest accounting of {lane}: {row}, "
                                     f"sent {sent[lane]}")
        kernels = status["kernels"]
        server_counts = (kernels["flash_fwd"], kernels["flash_dq"],
                         kernels["flash_dkv"])
        if server_counts != tuple(DIST_UPDATES * c for c in per_update):
            raise AssertionError(f"server launches {server_counts} over "
                                 f"{DIST_UPDATES} updates; expected "
                                 f"{DIST_UPDATES} x {per_update}")
        # The window step: K1 in every layer but the last, whose readout
        # row attends densely (phase 4's 3 per dispatch at 4 layers).
        if agent_counts != ((n_layers - 1) * dispatches, 0, 0):
            raise AssertionError(f"agent launches {agent_counts} over "
                                 f"{dispatches} dispatches")
        published = status["published"]
        if (agent_version, agent_digest) != (published["version"],
                                              published["digest"]):
            raise AssertionError(f"agent params at version {agent_version} "
                                 f"({agent_digest}) != published "
                                 f"{published}")
        if decoder is None or not (decoder.keyframes_applied >= 1
                                   and decoder.deltas_applied >= 1):
            raise AssertionError("the agent applied no keyframe and delta "
                                 "frame")
        kinds = status["publish_bytes"]
        timings = status["timings"]
        profile_path = Path(cfg["profile"]["path"])
        server.wait(lambda s: profile_path.exists(), "the learner profile")
        learner_profile = json.loads(profile_path.read_text())

        # SIGKILL drill: the last checkpoint must be on disk first.
        ckpt_dir = scratch / "checkpoints"
        server.wait(lambda s: CheckpointManager(str(ckpt_dir)).latest_step()
                    == DIST_UPDATES, "the checkpoint of the last update")
        v_before, agent_v_before = status["version"], agent.model_version
        server.stop(signal.SIGKILL)
        saved, _, _ = CheckpointManager(str(ckpt_dir)).restore()
        checkpoint = {"version": int(saved["version"]),
                      **train_state_digest(saved["train"])}
        for _ in range(OUTAGE_WAVES):
            wave()
        sent_outage = agent.spool.sent_counts()
        server = ChaosServer(root, {**cfg, "resume": True},
                             workdir / "server.log")
        status = server.wait(lambda s: True, "the restarted server")
        if status["resume"] != checkpoint:
            raise AssertionError(f"resumed {status['resume']} != checkpoint "
                                 f"{checkpoint}")

        def heal():
            # Give the reconnect replay a moment before playing on.
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline:
                s = server.status()
                if (s and s["version"] > v_before
                        and agent.model_version > agent_v_before):
                    return
                time.sleep(0.2)
            wave()

        server.wait(lambda s: (s["version"] > v_before
                               and agent.model_version > agent_v_before),
                    "training past the pre-kill version", poll=heal)
        agent.spool.replay()
        sent_total = agent.spool.sent_counts()

        def recovered(s):
            rows = s["accounting"]["agents"]
            return all(rows.get(lane, {}).get("max_seq") == sent_total[lane]
                       and rows[lane]["contiguous"] for lane in lane_ids)

        status = server.wait(recovered, "zero-loss accounting")
        for lane in lane_ids:
            row = status["accounting"]["agents"][lane]
            if row["accepted"] != sent_total[lane] or \
                    sent_total[lane] < sent_outage[lane]:
                raise AssertionError(f"{lane}: {row} vs sent {sent_total[lane]}")
        if status["accounting"]["duplicates"] < 1:
            raise AssertionError("the replay after recovery left no duplicate")
        if status["stats"]["learner_errors"]:
            raise AssertionError(f"restarted server: {status['stats']}: "
                                 f"{status['last_learner_error']}")
        check_clean_guardrails(status)
        return {"profile": learner_profile,
                "updates": DIST_UPDATES, "dispatches": dispatches,
                "wall": wall, "agent_counts": agent_counts,
                "server_counts": server_counts, "per_update": per_update,
                "digest": agent_digest, "version": agent_version,
                "keyframes": decoder.keyframes_applied,
                "deltas": decoder.deltas_applied, "publish_bytes": kinds,
                "timings": timings, "v_before": v_before,
                "v_after": status["version"], "agent_v_after": agent.model_version,
                "checkpoint": checkpoint, "sent_total": sum(sent_total.values()),
                "duplicates": status["accounting"]["duplicates"],
                "waves": waves}
    finally:
        if agent is not None:
            agent.disable_agent()
        server.stop()


def count_operations(fn) -> int:
    """The PyTorch operations ``fn`` dispatches, views and aliases left
    out: what it asks of the device, counted on the host."""
    from torch.utils._python_dispatch import TorchDispatchMode

    free = {"view", "_unsafe_view", "reshape", "alias", "detach",
            "lift_fresh"}

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ not in free:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def check_probes(device, learned: dict) -> dict:
    """Phase 12, part 1: the guardrail probes are observers on the card.
    ``PROBE_UPDATES`` updates of phase 5's learner from its initial params
    (fresh Adam state) on the first wave's epoch batches, twice with the
    probes off and once on: the two probes-off runs must agree bit for bit
    (else the differing parameters name the op that is not reproducible),
    and the probes-on run must agree with them bit for bit, with the same
    K1/K2/K3 launches per update (the probes launch none) and live probe
    scalars. Then profiles one update with probes on and off, and times
    the probe passes alone (CUDA events) with the operations they
    dispatch."""
    import torch

    from relayrl_tpu_torch.algorithms.reinforce import (
        ReinforceState,
        make_optimizers,
    )
    from relayrl_tpu_torch.guardrails import GuardProbes
    from relayrl_tpu_torch.guardrails.watchdog import (
        PROBE_NONFINITE,
        PROBE_PARAM_NORM,
        PROBE_UPDATE_NORM,
    )

    algo = learned["algo"]
    batches = epoch_batches(algo, learned["first_wave"], PROBE_UPDATES)

    def fresh(probes: bool):
        params = copy.deepcopy(learned["params0"])
        algo.state = ReinforceState(
            params, *make_optimizers(params, algo.pi_lr, algo.vf_lr))
        algo._guard_probes = GuardProbes(update_norm=True) if probes else None

    def run(probes: bool):
        fresh(probes)
        zero_flash_counts()
        for batch in batches:
            algo.train_on_batch(batch)
        algo.inflight.drain()
        torch.cuda.synchronize()
        counts = flash_counts()
        if probes and algo._guard_probes is None:
            raise AssertionError("the probes disabled themselves")
        state = {k: v.detach().clone()
                 for k, v in algo.state.params.state_dict().items()}
        return state, counts, dict(algo._last_metrics)

    def diff(a, b):
        return {k: (a[k].float() - b[k].float()).abs().max().item()
                for k in a if not torch.equal(a[k], b[k])}

    off1, counts, _ = run(False)
    off2, _, _ = run(False)
    not_reproducible = diff(off1, off2)
    if not_reproducible:
        raise AssertionError(
            f"two probes-off updates from the same params and batches "
            f"differ in {len(not_reproducible)} tensors: "
            f"{sorted(not_reproducible.items())[:8]}")
    on, on_counts, metrics = run(True)
    perturbed = diff(off1, on)
    if perturbed:
        raise AssertionError(f"probes perturbed training: "
                             f"{sorted(perturbed.items())[:8]}")
    n_layers = SLICE_ARCH["n_layers"]
    per_update = (n_layers * (4 + LEARNER["train_vf_iters"]), n_layers,
                  n_layers)
    want = tuple(PROBE_UPDATES * c for c in per_update)
    if counts != want or on_counts != want:
        raise AssertionError(f"launches over {PROBE_UPDATES} updates: probes "
                             f"off {counts}, on {on_counts}; expected {want}")
    if not (metrics[PROBE_NONFINITE] == 0 and metrics[PROBE_PARAM_NORM] > 0
            and metrics[PROBE_UPDATE_NORM] > 0
            and math.isfinite(metrics[PROBE_PARAM_NORM])):
        raise AssertionError(f"probe scalars {metrics}")
    # The probes' cost: one update with and without them, and the probe
    # passes alone, on the device.
    batch = batches[0]
    cost = {}
    for probes in (False, True):
        fresh(probes)
        print(f"[guard] one update, probes {'on' if probes else 'off'}:")
        cost["on" if probes else "off"] = profile_device(
            lambda: algo.train_on_batch(batch), 1, "update")
    probe = GuardProbes(update_norm=True)
    module = algo.state.params

    def passes():
        return probe.post_update(probe.pre_update(module), module)

    cost["probes_alone"] = {"ms": time_ms(passes, iters=20),
                            "operations": count_operations(passes)}
    algo.inflight.drain()
    return {"per_update": per_update, "counts": counts,
            "param_norm": metrics[PROBE_PARAM_NORM],
            "update_norm": metrics[PROBE_UPDATE_NORM],
            "tensors": len(off1), "cost": cost}


class LoudRecall:
    """``RecallEnv`` whose every step pays ``DIVERGE_REWARD``: finite
    rewards that pass ingest validation and overflow the learner."""

    def __init__(self):
        from relayrl_tpu_torch.envs import RecallEnv

        self.env = RecallEnv(LEARNER_HORIZON, N_CUES)
        self.observation_space = self.env.observation_space
        self.action_space = self.env.action_space

    def reset(self, seed=None):
        return self.env.reset(seed=seed)

    def step(self, action):
        obs, _, terminated, truncated, info = self.env.step(action)
        return obs, DIVERGE_REWARD, terminated, truncated, info


def _counter(status: dict, name: str, **labels) -> float:
    """One counter of the server's telemetry snapshot (0 when absent)."""
    return sum(m["value"] for m in status["telemetry"]["metrics"]
               if m["name"] == name
               and all(m["labels"].get(k) == v for k, v in labels.items()))


def guardrails_drill(device, root: Path, workdir: Path) -> dict:
    """Phase 12, part 2: the guardrails drills on the card. A chaos_server
    process trains phase 5's learner over ``GUARD_TRANSPORT`` from the
    default config (addresses and scratch only). Agent B's poisoned sends
    are rejected ``nonfinite`` until each of its lanes is quarantined after
    ``strike_threshold`` strikes; its next sends come back as typed
    quarantine nacks and its spool discards them. Agent A's clean episodes
    are all accepted once and train. Then A's loud wave drives the params
    non-finite: the watchdog (or the publish gate) trips exactly one
    rollback to the newest healthy checkpoint (params and Adam steps equal
    to it, bit for bit), under a version above the poisoned line, with a
    forced keyframe that A installs sha256-equal. A clean epoch after it
    trains on the restored line (not halted; the restored ledger has
    un-seen the loud wave's seqs). No agent ever installs non-finite
    params; no learner error, no probe disabled."""
    import shutil

    import torch

    from relayrl_tpu_torch import faults
    from relayrl_tpu_torch.checkpoint.manager import (
        CheckpointManager,
        train_state_digest,
    )
    from relayrl_tpu_torch.config import ConfigLoader
    from relayrl_tpu_torch.envs import RecallEnv, SyncVectorEnv
    from relayrl_tpu_torch.runtime.agent import VectorAgent
    from relayrl_tpu_torch.runtime.vector_actor import run_vector_gym_loop
    from relayrl_tpu_torch.weights import params_to_jax, tree_digest

    t_start = time.perf_counter()
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    guard_cfg = ConfigLoader(None, None,
                             create_if_missing=False).get_guardrails_params()
    strikes = int(guard_cfg["strike_threshold"])
    addr = f"127.0.0.1:{_free_port()}"
    env = RecallEnv(LEARNER_HORIZON, N_CUES)
    arch = SLICE_ARCH
    hyperparams = {"model_kind": arch["kind"], "seed": SEED, "seed_salt": 0,
                   **{k: v for k, v in arch.items()
                      if k not in ("kind", "has_critic", "precision")},
                   **LEARNER}
    scratch = workdir / "server"
    cfg = {"algorithm": "REINFORCE",
           "obs_dim": int(env.observation_space.shape[0]),
           "act_dim": int(env.action_space.n), "hyperparams": hyperparams,
           "device": str(device), "scratch": str(scratch),
           "server_type": GUARD_TRANSPORT, "bind_addr": addr,
           "config": {"learner": {"precision": arch["precision"]}},
           "digests": True, "status_path": str(workdir / "status.json")}
    agent_config = workdir / "agent_config.json"
    agent_config.write_text(json.dumps({}))
    n_layers = arch["n_layers"]
    per_update = (n_layers * (4 + LEARNER["train_vf_iters"]), n_layers,
                  n_layers)

    installs = []  # (agent, version, all params finite) per install

    def watch_installs(name, agent):
        host = agent.host
        original = host.swap_from_wire

        def swap(version, blob):
            out = original(version, blob)
            with host._lock:
                finite = all(bool(torch.isfinite(p).all())
                             for p in host.params.parameters())
            installs.append((name, int(version), finite))
            return out

        host.swap_from_wire = swap

    server = ChaosServer(root, cfg, workdir / "server.log")
    agents = {}
    try:
        server.wait(lambda s: True, "the server to come up")
        common = {"config_path": str(agent_config), "seed": SEED,
                  "probe": False, "device": device,
                  "server_type": GUARD_TRANSPORT, "server_addr": addr}
        # B's transport takes the poison plan's send site at construction;
        # the plan is cleared before A's is built.
        faults.install_plan(faults.FaultPlan(seed=SEED, rules=[
            faults.FaultRule(site="agent.send", op="nan_poison", prob=1.0)]))
        try:
            agents["B"] = VectorAgent(
                num_envs=GUARD_LANES_B, identity="poisoned",
                model_path=str(workdir / "client_model_b.rlx"), **common)
        finally:
            faults.install_plan(None)
        agents["A"] = VectorAgent(
            num_envs=DIST_LANES, identity="clean",
            model_path=str(workdir / "client_model_a.rlx"), **common)
        for name, agent in agents.items():
            watch_installs(name, agent)
        zero_flash_counts()  # after each agent's validation forward
        b_discards = []
        original_discard = agents["B"].spool.discard

        def discard(agent_id, seq):
            b_discards.append((agent_id, seq))
            original_discard(agent_id, seq)

        agents["B"].spool.discard = discard
        venvs = {"A": SyncVectorEnv([lambda: RecallEnv(LEARNER_HORIZON, N_CUES)]
                                    * DIST_LANES),
                 "B": SyncVectorEnv([lambda: RecallEnv(LEARNER_HORIZON, N_CUES)]
                                    * GUARD_LANES_B),
                 "loud": SyncVectorEnv([LoudRecall] * DIST_LANES)}
        waves = {"A": 0, "B": 0, "loud": 0}
        dispatches0 = {n: a.host.dispatches for n, a in agents.items()}

        def wave(name):
            agent = agents["A" if name == "loud" else name]
            run_vector_gym_loop(agent, venvs[name], LEARNER_HORIZON,
                                seed=SEED + 100 * len(name) + waves[name])
            waves[name] += 1

        lanes_b = list(agents["B"].agent_ids)
        lanes_a = list(agents["A"].agent_ids)

        # 1. The poisoned agent: strikes, then quarantine (A trains).
        for i in range(strikes):
            if i < GUARD_CLEAN_WAVES:
                wave("A")
            wave("B")
        status = server.wait(
            lambda s: sorted(s["guardrails"]["quarantine"]["quarantined"])
            == sorted(lanes_b)
            and s["stats"]["updates"] == GUARD_CLEAN_WAVES,
            "B's lanes quarantined and A's epochs trained")
        depth_b = agents["B"].spool.depth
        wave("B")  # every send now comes back as a typed quarantine nack
        status = server.wait(
            lambda s: _counter(s, "relayrl_guard_quarantine_rejects_total")
            >= GUARD_LANES_B, "the quarantine nacks")
        sent = {n: a.spool.sent_counts() for n, a in agents.items()}
        rejected = {m["labels"]["reason"]: m["value"]
                    for m in status["telemetry"]["metrics"]
                    if m["name"] == "relayrl_guard_rejected_total"}
        nacks = _counter(status, "relayrl_guard_quarantine_rejects_total")
        quarantine = status["guardrails"]["quarantine"]
        if rejected != {"nonfinite": strikes * GUARD_LANES_B}:
            raise AssertionError(f"rejections {rejected}; expected "
                                 f"{strikes * GUARD_LANES_B} nonfinite")
        if (nacks != GUARD_LANES_B or len(b_discards) != GUARD_LANES_B
                or agents["B"].spool.depth != depth_b):
            raise AssertionError(
                f"quarantine nacks: server {nacks}, B's spool discarded "
                f"{b_discards}, depth {agents['B'].spool.depth} (was "
                f"{depth_b})")
        if quarantine["quarantines_total"] != GUARD_LANES_B:
            raise AssertionError(f"quarantine {quarantine}")
        for lane in lanes_a:
            row = status["accounting"]["agents"].get(lane)
            if row != {"max_seq": sent["A"][lane], "accepted": sent["A"][lane],
                       "contiguous": True}:
                raise AssertionError(f"ingest accounting of {lane}: {row}, "
                                     f"sent {sent['A'][lane]}")
        stats = status["stats"]
        if (stats["trajectories"] != GUARD_CLEAN_WAVES * DIST_LANES
                or stats["dropped"] or stats["learner_errors"]):
            raise AssertionError(f"server stats {stats}: "
                                 f"{status['last_learner_error']}")
        quarantined = {"rejected": rejected, "nacks": nacks,
                       "discards": len(b_discards),
                       "quarantines": quarantine["quarantines_total"]}

        # 2. The divergence: the newest healthy checkpoint first.
        ckpt_dir = scratch / "checkpoints"
        server.wait(lambda s: (CheckpointManager(str(ckpt_dir)).healthy_steps()
                               or [None])[-1] == GUARD_CLEAN_WAVES
                    and s["version"] == GUARD_CLEAN_WAVES
                    and agents["A"].model_version == GUARD_CLEAN_WAVES,
                    "the healthy checkpoint of the last clean update")
        healthy_step = CheckpointManager(str(ckpt_dir)).healthy_steps()[-1]
        saved, _, _ = CheckpointManager(str(ckpt_dir)).restore(healthy_step)
        healthy = train_state_digest(saved["train"])
        decoder = agents["A"].host._wire_decoder
        keyframes_before = 0 if decoder is None else decoder.keyframes_applied
        wave("loud")
        status = server.wait(
            lambda s: s["guardrails"]["rollbacks_total"] >= 1
            and "rolled_back" in s
            and (s.get("published") or {}).get("version")
            == s["rolled_back"]["version"]
            and agents["A"].model_version == s["rolled_back"]["version"],
            "the rollback, its publish and A's install")
        time.sleep(1.0)  # a second rollback, if any, would land by now
        status = server.status()
        guard = status["guardrails"]
        rolled = status["rolled_back"]
        poisoned_version = GUARD_CLEAN_WAVES + 1
        if guard["rollbacks_total"] != 1 or guard["halted"]:
            raise AssertionError(f"rollbacks {guard['rollbacks_total']}, "
                                 f"halted {guard['halted']}")
        trip = guard["watchdog"]["last_trip"]
        if guard["watchdog"]["trips_total"] != 1 or trip["signal"] not in (
                "nonfinite_params", "param_norm", "publish_nonfinite"):
            raise AssertionError(f"watchdog {guard['watchdog']}")
        if {k: rolled[k] for k in ("params", "adam_steps")} != healthy:
            raise AssertionError(f"restored {rolled} != healthy checkpoint "
                                 f"{healthy_step} {healthy}")
        if not rolled["version"] > poisoned_version:
            raise AssertionError(f"version after rollback {rolled['version']}"
                                 f" <= poisoned line {poisoned_version}")
        if status["last_publish"]["kind"] != "keyframe":
            raise AssertionError(f"rollback publish {status['last_publish']}")
        with agents["A"].host._lock:
            a_version = agents["A"].host.version
            a_digest = tree_digest(params_to_jax(agents["A"].host.params))
        decoder = agents["A"].host._wire_decoder
        if (a_version, a_digest) != (status["published"]["version"],
                                     status["published"]["digest"]) \
                or decoder is None \
                or decoder.keyframes_applied <= keyframes_before:
            raise AssertionError(
                f"A at version {a_version} ({a_digest}), keyframes "
                f"{keyframes_before} -> {decoder.keyframes_applied}; "
                f"published {status['published']}")
        # 3. Not halted: a clean epoch after the rollback trains on the
        # restored line and reaches A. The restored dedup ledger is the
        # healthy checkpoint's, so the loud wave's seqs are un-seen.
        wave("A")
        after = rolled["version"] + 1
        status = server.wait(
            lambda s: s["version"] == after
            and (s.get("published") or {}).get("version") == after
            and agents["A"].model_version == after,
            "a clean update after the rollback")
        guard = status["guardrails"]
        if (guard["rollbacks_total"] != 1 or guard["halted"]
                or guard["watchdog"]["trips_total"] != 1):
            raise AssertionError(f"after the rollback: {guard}")
        sent_a = agents["A"].spool.sent_counts()
        for lane in lanes_a:
            row = status["accounting"]["agents"].get(lane)
            if row != {"max_seq": sent_a[lane], "accepted": sent_a[lane] - 1,
                       "contiguous": False}:
                raise AssertionError(f"{lane} after the rollback: {row}, "
                                     f"sent {sent_a[lane]}")
        with agents["A"].host._lock:
            a_after = tree_digest(params_to_jax(agents["A"].host.params))
        if a_after != status["published"]["digest"]:
            raise AssertionError(f"A at version {after}: {a_after} != "
                                 f"{status['published']}")
        if not installs or not all(ok for _, _, ok in installs):
            raise AssertionError(f"installs (agent, version, finite): "
                                 f"{installs}")
        if status["stats"]["learner_errors"] or status["probes_disabled"]:
            raise AssertionError(f"learner errors "
                                 f"{status['stats']['learner_errors']}, probes "
                                 f"disabled {status['probes_disabled']}: "
                                 f"{status['last_learner_error']}")
        kernels = status["kernels"]
        server_counts = (kernels["flash_fwd"], kernels["flash_dq"],
                         kernels["flash_dkv"])
        updates = GUARD_CLEAN_WAVES + 2
        if server_counts != tuple(updates * c for c in per_update):
            raise AssertionError(f"server launches {server_counts} over "
                                 f"{updates} updates; expected {updates} x "
                                 f"{per_update}")
        dispatches = sum(a.host.dispatches - dispatches0[n]
                         for n, a in agents.items())
        agent_counts = flash_counts()
        if agent_counts != ((n_layers - 1) * dispatches, 0, 0):
            raise AssertionError(f"agent launches {agent_counts} over "
                                 f"{dispatches} dispatches")
        return {"transport": GUARD_TRANSPORT, "strikes": strikes,
                "quarantine": quarantined, "trip": trip,
                "healthy_step": healthy_step, "rolled_back": rolled,
                "poisoned_version": poisoned_version, "after": after,
                "blocked": _counter(status,
                                    "relayrl_guard_publish_blocked_total"),
                "installs": len(installs), "server_counts": server_counts,
                "per_update": per_update, "updates": updates,
                "agent_counts": agent_counts, "dispatches": dispatches,
                "waves": dict(waves), "keyframes": (keyframes_before,
                                                    decoder.keyframes_applied),
                "seconds": time.perf_counter() - t_start}
    finally:
        for agent in agents.values():
            agent.disable_agent()
        server.stop()


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
    for name, log in _kernels.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[build] {name}: {line.strip()}")
    check_tensor_cores()

    # 3. kernel vs plain
    main_flash = check_flash(device)
    main_bwd = check_flash_bwd(device)

    # 4. serving slice
    arch = slice_arch()
    zero_flash_counts()
    run = serve(device, arch, LANES, DISPATCHES)
    expected = 3 * DISPATCHES + run["validate_launches"]
    if flash_counts()[1:] != (0, 0):
        raise AssertionError(f"backward kernels launched while serving: {flash_counts()}")
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

    # 5. learner slice
    root = Path(__file__).resolve().parent
    learned = learn(device, root / "build" / "chip_smoke")
    algo, seconds = learned["algo"], learned["seconds"]
    fwd, dq, dkv = learned["launches"]
    print(f"[learn] {len(seconds)} updates of [{LEARNER['traj_per_epoch']}, "
          f"{LEARNER['bucket_lengths'][0]}] fed by {LANES} port actors x "
          f"{LEARNER_WAVES} waves: launches per update (flash_fwd, flash_dq, "
          f"flash_dkv) {learned['per_update'][0]}, total {fwd}/{dq}/{dkv}; "
          f"upstream-gradient copies before the backward kernels "
          f"{learned['do_copies']}; learner and host at version "
          f"{algo.version}", flush=True)
    print("[learn] last metrics: " + ", ".join(
        f"{k}={v:.6g}" for k, v in learned["metrics"].items()))
    print(f"[learn] KL of the first update of each wave (same params as the "
          f"actors): {learned['on_policy_kl']} (tol {ON_POLICY_KL_TOL:g})")
    from relayrl_tpu_torch.ops.flash import flash_attention_plain

    cmp = compare_update(algo, learned["params0"], learned["batch"], device,
                         lambda q, k, v: flash_attention_plain(q, k, v, True)[0])
    print(f"[learn] first update, kernels vs plain attention: max metric diff "
          f"{cmp['metric_err']:.3e} (tol {UPDATE_METRIC_TOL:g} x max(1, |m|)), "
          f"max param diff {cmp['param_err']:.3e} (tol 2 x Adam step bound), "
          f"mean param diff {cmp['mean_diff_share']:.4f} of the mean movement "
          f"(tol {UPDATE_MEAN_DIFF_SHARE:g})", flush=True)
    steady = seconds[1:]
    print(f"[learn] {len(steady) / sum(steady):.3f} updates/s "
          f"({1e3 * sum(steady) / len(steady):.2f} ms per update over updates "
          f"2-{len(seconds)}, ingest and epoch log included; first update "
          f"{1e3 * seconds[0]:.2f} ms) on {smi.splitlines()[0]}", flush=True)
    batch = learned["batch"]
    profile_device(lambda: algo.train_on_batch(batch), 1, "update")

    # 6. ring kernels vs plain
    main_ring = check_ring_chunks(device)
    check_chunked_local(device)

    # 7. sequence-parallel learner
    from relayrl_tpu_torch.parallel import make_sharded_update
    from relayrl_tpu_torch.parallel import ring_flash as rf

    sp = learn_sp(device, root / "build" / "chip_smoke_sp",
                  learned)
    sp_algo, sp_seconds, mesh = sp["algo"], sp["seconds"], sp["mesh"]
    print(f"[sp-learn] {SP_UPDATES} updates of [{LEARNER['traj_per_epoch']}, "
          f"{LEARNER['bucket_lengths'][0]}] through make_sharded_update(..., "
          f"shard_time=True) over sp={SP} shards of one card: launches per update "
          f"(flash_fwd, flash_dq, flash_dkv, ring_chunk_fwd, ring_chunk_dq, "
          f"ring_chunk_dkv) {sp['per_update'][0]}; KL of the first update "
          f"{sp['metrics'][0]['KL']:.3e} (tol {ON_POLICY_KL_TOL:g})", flush=True)
    print("[sp-learn] last metrics: " + ", ".join(
        f"{k}={v:.6g}" for k, v in sp["metrics"][-1].items()))
    plain_ring = rf._make_ring_flash(mesh, "sp", True, ("dp", "fsdp"),
                                     rf.PLAIN_CHUNK_CALLS)
    cmp = compare_update(sp_algo, sp["params0"], sp["batches"][0], device, plain_ring,
                         wrap=lambda u: make_sharded_update(u, mesh, None, shard_time=True))
    print(f"[sp-learn] first update, ring kernels vs plain chunk versions: max metric "
          f"diff {cmp['metric_err']:.3e} (tol {UPDATE_METRIC_TOL:g} x max(1, |m|)), "
          f"max param diff {cmp['param_err']:.3e} (tol 2 x Adam step bound), mean "
          f"param diff {cmp['mean_diff_share']:.4f} of the mean movement (tol "
          f"{UPDATE_MEAN_DIFF_SHARE:g})", flush=True)
    err = compare_ring_evaluate(sp_algo, sp["state"].params, mesh, device)
    if not err <= TOLERANCE["bfloat16"]:
        raise AssertionError(f"evaluate ring vs flash_fwd: {err}")
    print(f"[sp-learn] evaluate [{LANES}, {SLICE_ARCH['max_seq_len']}] through the "
          f"ring vs through flash_fwd: max abs diff {err:.3e} (tol "
          f"{TOLERANCE['bfloat16']:g})")
    sp_steady = sp_seconds[1:]
    print(f"[sp-learn] {len(sp_steady) / sum(sp_steady):.3f} updates/s "
          f"({1e3 * sum(sp_steady) / len(sp_steady):.2f} ms per update over updates "
          f"2-{len(sp_seconds)}; first update {1e3 * sp_seconds[0]:.2f} ms) beside "
          f"the flash learner's {len(steady) / sum(steady):.3f} updates/s "
          f"({1e3 * sum(steady) / len(steady):.2f} ms) on {smi.splitlines()[0]}",
          flush=True)
    sp_batch = sp["batches"][0]
    profile_device(lambda: sp["sharded"](sp["state"], sp_batch), 1, "update")
    _, _, _, ring_fwd, ring_dq, ring_dkv = sp["launches"]

    # 8. the transformers at head dims 128 and 256
    for wide_arch in (WIDE_ARCH, WIDEST_ARCH):
        head_dim = wide_arch["d_model"] // wide_arch["n_heads"]
        wide = check_wide_transformer(device, root / "build" / f"chip_smoke_wide{head_dim}",
                                      wide_arch)
        print(f"[wide] transformer_discrete d_model {wide_arch['d_model']}, "
              f"{wide_arch['n_heads']} heads of {head_dim}, {wide_arch['n_layers']} layers, "
              f"T {wide_arch['max_seq_len']}, bf16, flash: evaluate kernel vs plain attention "
              f"max abs diff {wide['evaluate_err']:.3e} (tol {TOLERANCE['bfloat16']:g}); first "
              f"update launches (flash_fwd, flash_dq, flash_dkv) {wide['launches']}, max "
              f"metric diff {wide['metric_err']:.3e}, max param diff {wide['param_err']:.3e}, "
              f"mean param diff {wide['mean_diff_share']:.4f} of the mean movement",
              flush=True)

    # 9. the local loop
    cart = local_cartpole(device, root / "build" / "chip_smoke_cartpole")
    print(f"[local] LocalRunner CartPole-v1 mlp_discrete: {cart['updates']} updates, "
          f"{cart['steps']} env steps in {cart['wall']:.3f} s ({cart['steps'] / cart['wall']:.1f} "
          f"env steps/s, learner updates included) on {smi.splitlines()[0]}; avg return "
          f"{cart['avg_return']:.2f}; first update cuda vs cpu (f32): max metric diff "
          f"{cart['metric_err']:.3e}, max param diff {cart['param_err']:.3e} (tol "
          f"{MLP_PARAM_ATOL:g}); {cart['n_floored']} elements below Adam's floor "
          f"{ADAM_FLOOR:g}, max diff there {cart['floor_err']:.3e} (tol lr x steps)",
          flush=True)
    recall = local_recall(device, root / "build" / "chip_smoke_recall")
    print(f"[local] LocalRunner RecallEnv({RECALL_HORIZON}) transformer flash (head dim "
          f"{recall['head_dim']}): {len(recall['per_update'])} "
          f"updates over {recall['episodes']} episodes, {recall['steps']} env steps; launches "
          f"per update (flash_fwd, flash_dq, flash_dkv) {recall['per_update'][0]}, run total "
          f"{recall['launches']}; {recall['cached_steps']} of {recall['steps']} steps served "
          f"through the KV cache; avg return {recall['avg_return']:.2f}; first update card vs "
          f"cpu (f32): max metric diff {recall['metric_err']:.3e}, max param diff "
          f"{recall['param_err']:.3e} (tol {MLP_PARAM_ATOL:g}); {recall['n_floored']} "
          f"elements below Adam's floor {ADAM_FLOOR:g}, max diff there "
          f"{recall['floor_err']:.3e} (tol lr x steps)", flush=True)
    r_fwd, r_dq, r_dkv = recall["launches"]

    # 10. cached decode
    decode = check_cached_decode(device)
    print(f"[decode] PolicyActor {SLICE_ARCH['d_model']}x{SLICE_ARCH['n_layers']} (T "
          f"{SLICE_ARCH['max_seq_len']}, bf16) through the KV cache vs through the window, "
          f"{CACHED_EPISODES} RecallEnv({HORIZON}) episodes, hot swap at step "
          f"{CACHED_SWAP_AT}: over {decode['compared']} positions before the window rolls, "
          f"max abs diff logp(fixed action) {decode['errs']['logp']:.3e} (tol "
          f"{decode['bars']['logp']:.3e}), v {decode['errs']['v']:.3e} (tol "
          f"{decode['bars']['v']:.3e}); sampled actions agree at "
          f"{100 * decode['agreement']:.2f}% of them; prefills {decode['prefills']} (one "
          f"per swap); no flash kernel on the cached path; ms per env step, cached "
          f"{decode['cached_ms']:.3f} vs window {decode['window_ms']:.3f} on "
          f"{smi.splitlines()[0]}", flush=True)

    # 11. the distributed loop
    dist = distributed_loop(device, root, root / "build" / "chip_smoke_dist")
    d_fwd, d_dq, d_dkv = dist["server_counts"]
    a_fwd = dist["agent_counts"][0]
    steps_per_s = DIST_LANES * dist["dispatches"] / dist["wall"]
    timings = dist["timings"]
    kinds = dist["publish_bytes"]
    print(f"[dist] TrainingServer (chaos_server process) + VectorAgent ({DIST_LANES} "
          f"RecallEnv({LEARNER_HORIZON}) lanes, this process) over ZMQ on one card: "
          f"{dist['updates']} updates; server launches (flash_fwd, flash_dq, flash_dkv) "
          f"{dist['server_counts']} = {dist['updates']} x {dist['per_update']}; agent "
          f"flash_fwd {a_fwd} = {SLICE_ARCH['n_layers'] - 1} x {dist['dispatches']} "
          f"dispatches; agent params at version {dist['version']} == published "
          f"(sha256 {dist['digest'][:16]}); {dist['keyframes']} keyframe(s), "
          f"{dist['deltas']} delta(s) applied", flush=True)
    print(f"[dist] SIGKILL at version {dist['v_before']}, {OUTAGE_WAVES} wave(s) into "
          f"the outage, resume at the checkpoint (version {dist['checkpoint']['version']}, "
          f"params and Adam steps equal): server at version {dist['v_after']}, agent at "
          f"{dist['agent_v_after']}; accepted == max_seq == sent ({dist['sent_total']} "
          f"over {DIST_LANES} lanes), contiguous, {dist['duplicates']} duplicate(s)",
          flush=True)
    print(f"[dist] (not gated) {steps_per_s:.1f} env steps/s at the agent over "
          f"{dist['updates']} waves; server dispatch {1e3 * timings['dispatch_s'] / dist['updates']:.2f} "
          f"ms and device wait {1e3 * timings['device_wait_s'] / dist['updates']:.2f} ms "
          f"per update; publish bytes keyframe {kinds.get('keyframe')}, delta "
          f"{kinds.get('delta')}; on {smi.splitlines()[0]}", flush=True)
    prof = dist["profile"]
    window_ms = prof["timings_ms"]["dispatch_s"]
    first_ms = 1e3 * timings["dispatch_s"] - window_ms * prof["updates"]

    def read(key):
        value = prof.get(key)
        return "not measured" if value is None else f"{value:.2f} ms"

    print(f"[dist] (not gated) server learner over updates 2-"
          f"{1 + prof['updates']} beside the agent (torch.profiler and the "
          f"learner thread's CPU clock in the chaos_server process): dispatch "
          f"{window_ms:.2f} ms per update (the first update {first_ms:.2f} "
          f"ms), on a CPU {read('learner_cpu_ms')}, waiting for a core "
          f"{read('learner_runqueue_ms')}, fence "
          f"{prof['timings_ms']['device_wait_s']:.2f} ms; device busy "
          f"{read('device_busy_ms')} in {prof['device_operations']:.0f} "
          f"operations per update; wall {prof['wall_ms']:.2f} ms per update "
          f"(the agent's waves pace it); on {smi.splitlines()[0]}", flush=True)
    for key, ms, count in prof["top_kernels"]:
        print(f"[dist]   {ms:8.4f} ms x{count:<7.1f} {key}")

    # 12. guardrails on the card
    probes = check_probes(device, learned)
    cost = probes["cost"]

    def fmt(c):
        return ("not measured" if c is None else
                f"{c['busy_ms']:.4f} ms device busy in {c['operations']:.0f} "
                f"operations (wall {c['wall_ms']:.2f} ms)")

    print(f"[guard] probes are observers: {PROBE_UPDATES} updates from the same "
          f"params and batches, probes off twice and on once, bit-equal over "
          f"{probes['tensors']} tensors; launches (flash_fwd, flash_dq, "
          f"flash_dkv) {probes['counts']} = {PROBE_UPDATES} x "
          f"{probes['per_update']} with and without; GuardParamNorm "
          f"{probes['param_norm']:.6g}, GuardUpdateNorm "
          f"{probes['update_norm']:.6g}", flush=True)
    alone = cost["probes_alone"]
    print(f"[guard] per update, probes off: {fmt(cost['off'])}; probes on: "
          f"{fmt(cost['on'])}; the probe passes alone: {alone['ms']:.4f} ms on "
          f"the device (CUDA events), {alone['operations']} operations; on "
          f"{smi.splitlines()[0]}", flush=True)
    guard = guardrails_drill(device, root, root / "build" / "chip_smoke_guard")
    q = guard["quarantine"]
    rolled = guard["rolled_back"]
    print(f"[guard] chaos_server over {guard['transport']} from the default "
          f"config; agent B ({GUARD_LANES_B} lanes, nan_poison on every send): "
          f"{q['rejected']} rejected, {q['quarantines']} lanes quarantined "
          f"after {guard['strikes']} strikes each, then {q['nacks']} typed "
          f"quarantine nacks on the wire, {q['discards']} entries discarded by "
          f"its spool; agent A ({DIST_LANES} lanes) accepted == max_seq == "
          f"sent over {GUARD_CLEAN_WAVES} clean epochs", flush=True)
    print(f"[guard] a wave of rewards {DIVERGE_REWARD:g}: watchdog trip "
          f"{guard['trip']['signal']} (publishes blocked {guard['blocked']:g}), "
          f"exactly 1 rollback to healthy step {guard['healthy_step']} (params "
          f"sha256 {rolled['params'][:16]} and Adam steps "
          f"{rolled['adam_steps']} equal to the checkpoint's), version "
          f"{rolled['version']} > poisoned line {guard['poisoned_version']}, "
          f"forced keyframe installed by A sha256-equal (keyframes "
          f"{guard['keyframes'][0]} -> {guard['keyframes'][1]}); a clean "
          f"epoch after it trained to version {guard['after']}, not halted; "
          f"{guard['installs']} installs, all finite; server launches "
          f"{guard['server_counts']} = {guard['updates']} x "
          f"{guard['per_update']}, agents' flash_fwd {guard['agent_counts'][0]} "
          f"= {SLICE_ARCH['n_layers'] - 1} x {guard['dispatches']} dispatches; "
          f"{guard['seconds']:.1f} s", flush=True)
    g_fwd, g_dq, g_dkv = guard["server_counts"]
    ga_fwd = guard["agent_counts"][0]

    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "relayrl_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "relayrl_tpu/ops/flash.py:116",
        "launches": (run["launches"] + fwd + r_fwd + decode["launches"] + a_fwd + d_fwd
                     + ga_fwd + g_fwd),
        "launches_by_path": {"serving": run["launches"], "learner": fwd, "local_loop": r_fwd,
                             "decode_vs_window": decode["launches"],
                             "distributed_agent": a_fwd, "distributed_server": d_fwd,
                             "guardrails_agents": ga_fwd, "guardrails_server": g_fwd},
        **main_flash,
    }, {
        "name": "flash_dq",
        "route": "cuda",
        "source": "relayrl_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "relayrl_tpu/ops/flash.py:223",
        "launches": dq + r_dq + d_dq + g_dq,
        "launches_by_path": {"learner": dq, "local_loop": r_dq, "distributed_server": d_dq,
                             "guardrails_server": g_dq},
        **main_bwd["flash_dq"],
    }, {
        "name": "flash_dkv",
        "route": "cuda",
        "source": "relayrl_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "relayrl_tpu/ops/flash.py:255",
        "launches": dkv + r_dkv + d_dkv + g_dkv,
        "launches_by_path": {"learner": dkv, "local_loop": r_dkv,
                             "distributed_server": d_dkv, "guardrails_server": g_dkv},
        **main_bwd["flash_dkv"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "relayrl_tpu_torch/csrc/ring_flash.cu",
        "replaces": replaces,
        "launches": launches,
        "launches_by_path": {"sp_learner": launches},
        **main_ring[name],
    } for name, replaces, launches in (
        ("ring_chunk_fwd", "relayrl_tpu/parallel/ring_flash.py:86", ring_fwd),
        ("ring_chunk_dq", "relayrl_tpu/parallel/ring_flash.py:119", ring_dq),
        ("ring_chunk_dkv", "relayrl_tpu/parallel/ring_flash.py:147", ring_dkv))]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
