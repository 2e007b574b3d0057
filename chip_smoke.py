#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``relayrl_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

(``python3 chip_smoke.py --recall-sweep FIRST LAST`` instead runs phase
9's recall card-vs-CPU comparison alone over seed salts FIRST .. LAST - 1
and gates nothing: see :func:`recall_sweep`; ``--moe-golden-sweep FIRST
LAST`` runs phase 16's recall_moe golden over them: see
:func:`moe_golden_sweep`.)

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
   beside SDPA's; K2 and K3 also at PPO's minibatch shape ``[2, 256, 8,
   32]`` (bf16 causal), timed;
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
   on the CPU (f32; for the recall learner, an element outside Adam's floor
   past the bar passes within twice the difference the same update through the plain attention
   on the card shows against the CPU: the kernels are held to the noise of
   the arithmetic without them);
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
   Its server pins ``native_grpc: false``: typed nacks exist only on the
   grpcio servicer (the native C++ gRPC server acks before Python sees a
   send);
13. the async fleet over the native plane, through a relay: IMPALA's first
   update on phase 5's first batch through K1-K3 against the plain
   attention (phase 5's bars; 4/4/4 launches; behavior log-probs from the
   f32 model, equidistant from both sides: V-trace's truncated ratios,
   multiplied over 255 steps, turn the plain side's extra distance from
   the actors' K1 log-probs into a shift, printed beside it) and, at f32,
   against the CPU (``compare_update_to_cpu``), RhoMean and KL finite, and
   its update time and device busy share in this process; then IMPALA at phase 5's
   arch in a ``chaos_server`` process over ``server_type: "native"``
   (default guardrails, 8 episodes per epoch), a relay process (``python
   -m relayrl_tpu_torch.relay``: native upstream, zmq downstream, a file
   spool), ``VectorAgent`` A (8 ``RecallEnv(255)`` lanes) through the
   relay over zmq and ``VectorAgent`` B (2 lanes) straight over native.
   Gates: the server's launches per update exactly 4/4/4 (one evaluate,
   one backward); the agents' K1 per dispatch (3); the native codec
   decodes every ingested trajectory and Python none (the server's
   ``decoded_by`` equals the accepted count); A and B hold the published
   params sha256-equal; the relay SIGKILL drill (a wave into the outage,
   a replacement relay on the same spool): each leaf's sequence accepted
   exactly once (accepted == max_seq == sent, contiguous, trained ==
   sent), training past the kill and A installing it; a resync from A
   served from the replacement's cached keyframe; RhoMean and KL finite
   in every update's log row; no learner error, a clean guardrail book.
   Not gated: the native decode against the Python decode per trajectory
   on B's payloads, the relay hop's added delivery and install latency,
   the server learner's profile; logs under ``build/chip_smoke_fleet/``;
14. PPO on the flagship, in this process (8 episodes per epoch, 4
   minibatches of 2 rows, 4 sweeps: 16 minibatch steps per update): its
   first update through K1-K3 against the plain attention and, at f32,
   against the CPU on the same index sets; 8 updates on phase 5's first
   wave at exactly 64/64/64 launches each; the KL stop (``target_kl`` -1:
   ``StopIter`` 1 on the card and at f32 against the CPU, the pi params
   and pi Adam state after the update bit-equal to those after its first
   minibatch); PPO on CartPole-v1 above an average return of 40 within 12
   epochs and IMPALA's P(action 1) above 0.6 from stale behavior
   (tests/test_ppo.py's and tests/test_impala.py's bars) on the card; the
   update time and device busy share;
15. the off-policy family on the card, each of DQN, C51, DDPG, TD3 and SAC
   at its golden's ``config.json`` (``examples/golden/{cartpole_dqn,
   cartpole_c51, ddpg_pendulum, td3_pendulum, sac_pendulum}``: f32 MLP
   128x128, batch 256, ring 100,000), its ring filled past
   ``update_after`` by a seeded random behavior on CartPole or Pendulum:
   one update on the card against the same update on the CPU from the same
   params, on the same batch with the same injected noise (phase 9's bars
   and Adam-floor rule); ``updates_per_dispatch`` 4 against 4 single
   updates, bit-equal; the ms per gradient update (not gated); DQN on
   CartPole and SAC on Pendulum through ``LocalRunner`` at the goldens'
   hyperparameters for a few updates (returns finite, versions advancing
   with every hot swap, DQN's epsilon annealed into every bundle; env
   steps/s printed); then DQN in a ``chaos_server`` process over ZMQ fed
   by a ``VectorAgent`` of 8 CartPole lanes: exact ingest accounting, more
   gradient updates than ingests (the server trains the list of batches
   each ingest returns), the agent's params sha256-equal to the publish,
   no learner error, a clean guardrail book. K1-K6 launch zero times on
   every off-policy path, in both processes;
16. the other model families. (a) Pixel, at the Pong north star's shape:
   the Nature CNN on ``make_atari("synthetic")``'s 84x84x4 uint8 frames,
   f32: ``evaluate`` card vs CPU (the f32 bar); PPO's first update (the
   first epoch of its ``LocalRunner``) card vs CPU on the same index sets
   and one pixel DQN update on a uint8 ring card vs CPU (phase 9's bars);
   ``LocalRunner`` PPO at the ``pixel_ppo_catch`` golden's ``config.json``
   (36x36x2, uncut) for a few updates; the ``ppo_pixel36_zmq`` matrix
   cell in a ``chaos_server`` over ZMQ from a ``VectorAgent`` of 8 lanes,
   uint8 frames on the wire, exact accounting, the install sha256-equal to
   the publish; K1-K6 launch zero times on every pixel path, in both
   processes. (b) ``__graft_entry__.entry()``'s arch as
   ``transformer_moe_discrete`` (4 experts, top-2): ``evaluate`` through K1
   against the plain attention (phase 4's bar), the first update through
   K1-K3 against the plain attention (phase 5's bars, 336/4/4 launches),
   ``expert_utilization`` summing to 1 per layer, the cached decode
   against the window over one episode (f32 at the f32 bar; bf16 at phase
   10's bars, the cached side's routes pinned to the window's); the
   ``recall_moe``
   golden's ``config.json`` (uncut, dense attention) through
   ``LocalRunner`` to an epoch of average return 1.0. (c) The same arch
   as ``transformer_pp_discrete``: the flagship's weights stacked give
   ``transformer_discrete``'s ``evaluate`` bit for bit; the first update
   through K1-K3 against the plain attention at 336/4/4 launches;
17. the anakin tier: the six device envs card vs CPU, the cartpole
   golden's MLP and the flagship as captured windows bit-equal to the
   eager window, 96 K1 per flagship replay, an anakin agent feeding phase
   11's learner over ZMQ;
18. the serving plane. (a) The flagship in a standalone ``InferenceService``
   (max_batch 64) on the card, served over ZMQ to a
   ``MultiplexedRemoteClient`` of 64 ``RecallEnv(300, 16)`` lanes for
   ``SERVE_STEPS`` steps: every dispatch replayed through the keyed window
   step at its bucket, bit for bit, and every shipped action record equal
   to the row served for its lane's session and step; flash_fwd launches
   = dispatches x phase 4's per-dispatch count; a bucket-64 dispatch's rows recomputed at
   buckets 1 and 32 (the same actions, logp_a within the bf16 bar); the
   rows per dispatch, requests/s, ms per dispatch and device ms per
   dispatch printed. (b) Phase 11's learner in a
   ``TrainingServer(serving=True)`` on the card, fed by 8
   ``RemoteActorClient``s over ZMQ: 4 updates at exactly 336/4/4, each
   wave served at the version published before it, the clients at the
   last publish, exact ingest accounting. (c) A ``RemoteActorClient``
   over gRPC ``GetActions`` against a served ``mlp_discrete``: each
   action equal to the keyed step on the card, bit for bit;
19. the RLHF plane: ``RlhfScheduler`` against an in-process
   ``TrainingServer("IMPALA")`` on the card, the flagship generating over
   TokenGen (8-token vocabulary, 8-token prompts, up to 248 new tokens: a
   256-token context), the reward model (d_model 32, 1 layer, seed 7)
   scoring, ``params/(obs_embed|pos_embed|block_0)/`` frozen, on (a) the
   vector tier over ZMQ (4 updates), (b) the anakin tier (8-step windows
   captured as one CUDA graph, 4 updates), (c) thin clients of a
   ``TrainingServer(serving=True)`` (2 updates). Each: every shipped
   episode's terminal reward equal to the reward model's score of its
   tokens, re-scored from the emitted bytes; every ``bver`` within [0,
   the version held at emission]; exact ingest accounting; the frozen
   leaves bit-identical, the rest moved; the train-lag histogram once per
   trajectory; K1 = generation dispatches (or replays) x their K1 + 4 per
   update, K2 and K3 4 per update. (a) also scores 8 generations one at a
   time and as a batch: ``score_np`` and ``score_batch_np`` bit-equal, and
   the raw 1-row against 8-row forward printed;
20. the observability plane. (a) Phase 11's learner in a ``chaos_server``
   process with tracing at rate 1 and the fleet plane on (snapshot frames
   every 0.5 s, an exporter, an events journal), behind a ``python -m
   relayrl_tpu_torch.relay`` process, fed by a traced ``VectorAgent`` of 8
   ``RecallEnv(255)`` lanes in this process with its fleet emitter on, 3
   updates: every accepted trajectory traced env, encode, send, relay,
   ingest, dedup, staging, update (monotonic starts, no overlap inside a
   plane), every published version dispatch, fence, encode, publish,
   relay, receipt (relay and agent), swap; every age in [0, 300 s), one
   observation per trace in each process; ``python -m
   relayrl_tpu_torch.telemetry.trace`` over the three journals agreeing
   with this process's analysis, its data-age count the accepted count;
   the trace-side version lag within 0.5 of the train-lag histogram's;
   ``/fleet`` listing the three processes and ``telemetry.top --fleet``
   rendering them; every merged counter but the fleet frames' own equal
   to the sum of the three final registries, env steps those the agent
   took; no alert; 336/4/4 launches per update, 3 K1 per dispatch, the
   agent's params sha256-equal to the publish; hop, age and env-steps/s
   figures printed beside phase 11's. (b) Phase 18 (a) traced for 32
   steps: one ``serve`` trace per request (queue, dispatch), every
   dispatch still replayed bit for bit; phase 19's anakin tier traced for
   2 updates: the ``generate``, ``score`` and ``emit`` spans' episodes
   sum to the run's, every shipped episode traced env (stamped at its
   window's production) to update, graph == eager. (c) One phase 5 update
   inside ``utils.profiling.trace`` with ``annotate``: the Chrome trace
   lists K1, K2 and K3 at 336, 4 and 4 launches inside the annotated
   range;
21. the mesh learner: single-controller meshes of 8 that repeat the card,
   the flagship's widths, phase 5's REINFORCE hyperparameters and first
   batch. (a) ``transformer_pp_discrete`` under ``{dp 2, pp 4}``: the
   pipelined ``evaluate`` against the unpipelined one (phase 4's bar) at
   32 K1 (4 layers x 4 microbatches of one row x 2 data groups); the
   first update through K1-K3 at exactly 2,688/32/32 (84 forwards x 32,
   one backward's 32) against the same pipelined update through the
   plain attention and against the unpipelined update (336/4/4; phase 5's
   bars; the largest differences printed); each stage's layers and Adam
   moments on the device its coordinate names; the update's ms and device
   busy. (b) ``transformer_moe_discrete`` (4 experts, top-2) under ``{dp
   2, ep 4}``: one expert's stacks per ep device; the first update at
   exactly 336/4/4 against the unsharded update (336/4/4) and the plain
   attention (phase 5's bars, every side's routes pinned to the unsharded
   kernel side's); ``expert_utilization`` summing to 1 per layer. (c) The
   flagship (336/4/4) and the cartpole golden's ``mlp_discrete`` (no
   kernel) under ``{dp 2, fsdp 2, tp 2}``: each first update against its
   unsharded update (336/4/4 and none) within the JAX test's f32 bars
   (rtol 2e-4, atol 2e-5; bit-equality reported); the placed state's
   bundle byte-equal to the unplaced; the shards and the parameter and
   moment bytes per mesh coordinate. (d) ``build_algorithm("REINFORCE",
   model_kind="transformer_pp_discrete", ...)`` then ``enable_multihost``
   over ``{dp 2, pp 4}``: 2 epochs from ``receive_trajectory`` at exactly
   2,688/32/32 each; a port actor with no mesh serving the published
   bundle at 4 K1 a dispatch for 4 dispatches, its params sha256-equal to
   the learner's gathered params and the publish snapshot's. Each part's
   ms per update printed beside phase 5's;
22. the multi-process learner: ``MH_RANKS`` processes that this script
   starts (``chip_smoke.py --mh-rank``, ``subprocess``), each a rank of a
   ``torch.distributed`` group (``parallel/distributed.py``; on one card
   both ranks share it through gloo, with a card each the backend rule
   picks nccl), the learner's dp axis spanning them. (a) Phase 5's first
   batch, broadcast from rank 0 bit for bit, and a copy whose rank-1 rows
   are mostly padding: one flagship REINFORCE update each from phase 5's
   initial params, the ranks' params sha256-equal, 336/4/4 launches per
   rank, held to this process's single-process update of the same batch at
   phase 5's bars; ms per update and the all-reduces' share. (b) Phase
   11's learner as a two-rank ``TrainingServer`` (a ``chaos_server`` per
   rank, the checkpoint directory shared) fed over ZMQ by an 8-lane
   ``VectorAgent`` (one epoch a wave): every published version installed,
   both ranks at the same version with sha256-equal params, 336/4/4 per
   update each, only the coordinator with a transport and publishes,
   exact accounting; then a collective checkpoint, both ranks resumed from
   it and trained further, the accounting exact across the resume. (c)
   DQN and SAC at their goldens' widths: the coordinator's samples
   broadcast, 4 updates under dp 2 across the ranks, the networks
   sha256-equal and held to single-process updates on the same batches at
   phase 15's card-vs-CPU bars. A rank that fails, or a deadline that
   passes, fails the phase.

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

import contextlib
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
# The async fleet (phase 13): IMPALA at phase 5's arch in a chaos_server
# process over the native plane (8 episodes per epoch, one 256 bucket, the
# default guardrails). Agent A's DIST_LANES lanes reach it through a relay
# process (native upstream, zmq downstream); agent B's FLEET_LANES_B lanes
# go straight to it over native. FLEET_WAVES waves of both agents train it,
# then the relay is SIGKILLed after a wave of A's, A plays a wave into the
# outage, the relay restarts on the same spool, and both play on until the
# server trains past the kill and A installs it.
IMPALA_HP = {"traj_per_epoch": 8, "bucket_lengths": [256]}
FLEET_LANES_B = 2
FLEET_WAVES = 2
FLEET_TIMEOUT_S = 240
# The PPO learner (phase 14): phase 5's arch, one [8, 256] batch per
# update cut into minibatch_count minibatches of PPO_MINIBATCH_ROWS rows,
# train_iters sweeps: 16 minibatch steps per update, PPO_UPDATES updates
# on phase 5's first wave. Its learning checks run tests/test_ppo.py's
# CartPole check (PPO_CARTPOLE_HP, 12 epochs, average return above 40) and
# tests/test_impala.py's stale-behavior check (160 episodes from a policy
# that picks action 0 70% of the time, where action 1 pays; P(action 1) on
# 16 fixed observations above 0.6) on the card.
PPO_HP = {"traj_per_epoch": 8, "minibatch_count": 4, "train_iters": 4,
          "bucket_lengths": [256]}
PPO_MINIBATCH_ROWS = PPO_HP["traj_per_epoch"] // PPO_HP["minibatch_count"]
PPO_UPDATE_MINIBATCHES = PPO_HP["minibatch_count"] * PPO_HP["train_iters"]
PPO_UPDATES = LANES // PPO_HP["traj_per_epoch"]
PPO_CARTPOLE_HP = {"traj_per_epoch": 8, "minibatch_count": 2, "train_iters": 4,
                   "pi_lr": 1e-2, "vf_lr": 1e-2, "ent_coef": 0.01,
                   "target_kl": 0.05, "hidden_sizes": [32, 32]}
PPO_CARTPOLE_EPOCHS = 12
PPO_CARTPOLE_BAR = 40.0
STALE_EPISODES = 160
STALE_BAR = 0.6
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
# Phase 9's recall comparison holds an element outside Adam's floor that
# passes MLP_PARAM_ATOL to this many times the plain attention's card-vs-CPU
# difference at the same element (the same update on the card without the
# kernels): the policy step's +-lr moves on noise-driven trunk elements make
# the value head's 20 steps train on features that differ, in either
# arithmetic (PERF.md section 6).
PLAIN_NOISE_FACTOR = 2.0
# Element rules for an element outside Adam's floor that misses
# MLP_PARAM_ATOL: within PLAIN_NOISE_FACTOR times the card-vs-CPU difference
# of the plain attention at the element (the first, phase 9's gate), of the
# largest of all plain sides (plain_attn and NOISE_ATTENTIONS) at the
# element, or of the largest of all plain sides over the element's leaf.
# compare_update_to_cpu reports each rule's verdict, and --recall-sweep
# counts the salts each fails: the two wider rules fail the same salts as
# the gate (ROADMAP queue 3 item 9, PERF.md section 6), so the gate stays.
ELEMENT_RULES = ("plain attention at the element", "plain sides at the element",
                 "plain sides over the leaf")
# Each side's move of a qkv bias's key third (zero gradient in exact
# arithmetic) is held to Adam's step bound times this: the bias-corrected
# m_hat / (sqrt(v_hat) + eps) of f32 noise may round a hair above 1
# (tests/test_torch_reinforce.py holds the JAX package the same way).
KEY_BIAS_SLACK = 1 + 1e-3
# Phase 9's metrics that difference two losses (the loss after the update
# minus the loss before it) cancel the losses' leading digits, so their
# card-vs-CPU difference is the losses' rounding noise, not a share of
# their value. Each is held to the larger of its bar and PLAIN_NOISE_FACTOR
# times the largest card-vs-CPU difference of the same update through the
# plain attentions of NOISE_ATTENTIONS (more than one sample of the noise
# of the arithmetic without the kernels; PERF.md section 6).
DELTA_METRICS = ("DeltaLossPi", "DeltaLossV")
# Phase 15: the off-policy family at its goldens' configs
# (examples/golden/<name>/config.json: f32 MLP 128x128, batch 256, ring
# 100,000). OFFPOLICY_WARM updates before the card-vs-CPU update (so the
# targets have moved off the online networks), OFFPOLICY_TIMED updates
# timed, updates_per_dispatch OFFPOLICY_FUSED against single updates;
# LocalRunner updates (episodes that trained) per learning check; the DQN
# server's lanes and the ingests that trained before its gates.
OFFPOLICY_GOLDENS = {"DQN": "cartpole_dqn", "C51": "cartpole_c51",
                     "DDPG": "ddpg_pendulum", "TD3": "td3_pendulum",
                     "SAC": "sac_pendulum"}
OFFPOLICY_WARM = 3
OFFPOLICY_TIMED = 50
OFFPOLICY_FUSED = 4
OFFPOLICY_LOCAL = {"DQN": 20, "SAC": 4}
OFFPOLICY_LANES = 8
OFFPOLICY_SERVER_STEPS = 1600   # env steps over all lanes: update_after + ~600
OFFPOLICY_SERVER_INGESTS = 6
# The other model families (phase 16). Pixel: the Nature CNN at
# make_atari("synthetic")'s 84x84x4 uint8 frames, f32; PPO's first epoch of 8
# episodes (train_atari's pixel defaults) and the cartpole_dqn golden's DQN
# with the pixel trunk on a uint8 ring cut from 100,000 frames to 2,000
# (28,224 B each, twice: obs and obs2) and update_after from 1000 to 300.
PIXEL_FRAMES = 64
PIXEL_PPO_HP = {"traj_per_epoch": 8, "pi_lr": 1e-3, "seed_salt": 0}
PIXEL_PPO_UPDATES = 1
PIXEL_DQN_HP = {"obs_dtype": "uint8", "buffer_size": 2000, "update_after": 300}
# The pixel_ppo_catch golden's env (its README's command) and config, for a
# few updates in-process; the ppo_pixel36_zmq matrix cell's config
# (examples/run_matrix.py) in a server process over ZMQ.
PIXEL_GOLDEN_ENV = {"frame_size": 36, "frame_stack": 2, "frame_skip": 2,
                    "raw_size": 48, "shaped": True}
PIXEL_GOLDEN_UPDATES = 4
PIXEL_MATRIX_HP = {"traj_per_epoch": 4, "hidden_sizes": [32, 32],
                   "model_kind": "cnn_discrete", "obs_shape": [36, 36, 2], "pi_lr": 1e-3}
PIXEL_LANES = 8
PIXEL_SERVER_UPDATES = 3
# The flagship's arch as the MoE (the recall_moe golden's 4 experts, top-2)
# and the pipeline kinds; the recall_moe golden's run is capped at this
# many updates: about twice the slowest of the 68 seed salts of 0-69 that
# reached the bar on the card (7 to 95 updates; 2 stayed near 0.5 for 600:
# PERF.md section 6).
MOE_ARCH = {**SLICE_ARCH, "kind": "transformer_moe_discrete", "moe_experts": 4,
            "moe_top_k": 2}
PP_ARCH = {**SLICE_ARCH, "kind": "transformer_pp_discrete"}
MOE_GOLDEN_MAX_UPDATES = 200
# The golden's config stalls near 0.5 at a few percent of seed salts, in
# the JAX package as in the port (PERF.md section 6): a run that stalls
# tries one more salt, also from the process id, and fails when both stall.
MOE_GOLDEN_SECOND_SALT = 0x5A17
# Phase 17: the anakin tier. (a) each device env, ANAKIN_ENV_LANES lanes
# for ANAKIN_ENV_STEPS steps, card vs CPU (float fields of the float envs
# to ANAKIN_ENV_TOL, tests/test_jax_envs.py's bar); (b) the
# cartpole_reinforce_baseline golden's MLP, ANAKIN_MLP_LANES lanes; (c)
# phase 4's configuration, ANAKIN_SEQ_WINDOWS windows; (d) phase 11's
# learner fed by one anakin agent for ANAKIN_UPDATES updates. Windows of
# ANAKIN_UNROLL steps; ANAKIN_TIMED windows timed, graph and eager.
ANAKIN_ENVS = {"CartPole-v1": {}, "Pendulum-v1": {},
               "Recall-v0": {"horizon": HORIZON, "n_cues": N_CUES},
               "GridWorld-v0": {}, "Bandit-v0": {}, "TokenGen-v0": {}}
ANAKIN_FLOAT_ENVS = ("CartPole-v1", "Pendulum-v1")
ANAKIN_ENV_LANES = 256
ANAKIN_ENV_STEPS = 500
ANAKIN_ENV_TOL = 2e-6
ANAKIN_MLP_LANES = 1024
ANAKIN_UNROLL = 32
ANAKIN_SEQ_WINDOWS = 10
ANAKIN_TIMED = 5
ANAKIN_UPDATES = 4
MOE_GOLDEN_SWEEP_UPDATES = 600  # --moe-golden-sweep's cap per salt
# The serving plane (phase 18): (a) a MultiplexedRemoteClient of LANES
# RecallEnv(HORIZON, N_CUES) lanes over ZMQ to a standalone
# InferenceService holding the flagship (max_batch LANES) for SERVE_STEPS
# steps, every dispatch replayed through the keyed window step, a bucket-64
# dispatch's rows recomputed at SERVE_OTHER_BUCKETS; (b) phase 11's learner
# in a TrainingServer(serving=True) on the card fed by SERVE_CLIENTS thin
# clients over ZMQ for DIST_UPDATES updates; (c) a RemoteActorClient over
# gRPC GetActions against a served mlp_discrete for SERVE_GRPC_STEPS steps.
SERVE_STEPS = 320
SERVE_OTHER_BUCKETS = (1, 32)
SERVE_CLIENTS = LEARNER["traj_per_epoch"]
SERVE_GRPC_STEPS = 200
# The RLHF plane (phase 19): the RlhfScheduler against a TrainingServer
# ("IMPALA") on the card, the flagship as the policy over TokenGen with an
# 8-token vocabulary, 8-token prompts and up to 248 generated tokens (a
# 256-token context: the flagship's window), the reward model of
# rm_d_model 32, 1 layer, seed 7 as the scorer, the lower half frozen
# (benches/bench_rlhf.py's fine-tune recipe), on each generation tier for
# RLHF_UPDATES[tier] updates.
RLHF = {"vocab_size": 8, "prompt_len": 8, "max_new_tokens": 248,
        "scorer": "reward_model", "rm_d_model": 32, "rm_n_layers": 1, "rm_seed": 7,
        "lanes": 8, "score_batch": 8, "generation_unroll": 8,
        "max_episodes_per_version": 8, "pace_timeout_s": 3.0}
RLHF_FREEZE = "params/(obs_embed|pos_embed|block_0)/"
RLHF_FROZEN = ("params/obs_embed/", "params/pos_embed/", "params/block_0/")
RLHF_UPDATES = {"vector": 4, "anakin": 4, "remote": 2}
RLHF_TIMEOUT_S = 240
# Phase 20: phase 11's learner traced and fleet-aggregated behind a relay
# process, phases 18 (a) and 19 (anakin) rerun traced, the profiler
# around one update.
TRACED_UPDATES = 3
FLEET_INTERVAL_S = 0.5
TRACED_SERVE_STEPS = 32
TRACED_RLHF_UPDATES = 2
UPSTREAM_HOPS = ("env", "encode", "send", "relay", "ingest", "dedup", "staging",
                 "update")
MODEL_HOPS = ("dispatch", "fence", "encode", "publish", "relay", "receipt", "swap")
# Counters that the fleet plane's own snapshot frames move (frames sent and
# received, their bytes, the table's frame and section counts): a frame
# cannot carry the count of its own sending, so the root's merged value of
# these trails the processes' final registries by the last frames. Every
# other counter is held to the exact sum.
FLEET_SELF_COUNTERS = ("relayrl_transport_send_total",
                       "relayrl_transport_send_bytes_total",
                       "relayrl_transport_recv_total",
                       "relayrl_transport_recv_bytes_total")
FLEET_SELF_PREFIX = "relayrl_fleet_"

# The mesh learner (phase 21): single-controller meshes of MESH_SIZE
# devices that repeat the one card, the flagship's widths, phase 5's
# hyperparameters and first batch. (a) and (d) pipeline the pp flagship,
# (b) splits the MoE flagship's experts, (c) gathers fsdp shards and runs
# the cartpole golden's MLP tensor parallel.
MESH_SIZE = 8
PP_MESH = {"dp": 2, "pp": 4}
EP_MESH = {"dp": 2, "ep": 4}
FSDP_TP_MESH = {"dp": 2, "fsdp": 2, "tp": 2}
# tests/test_parallel.py's bars for a sharded update against its unsharded
# one (f32): parameters at rtol and atol, metrics at MESH_METRIC_RTOL.
MESH_RTOL, MESH_ATOL, MESH_METRIC_RTOL = 2e-4, 2e-5, 1e-4
MESH_EPOCHS = 2
MESH_ACTOR_LANES = 8
MESH_ACTOR_STEPS = 4
CARTPOLE_EPISODE_STEPS = 400

# The multi-process learner (phase 22): MH_RANKS processes started here,
# each a rank of a torch.distributed group whose dp axis they span. On one
# card both ranks share it through gloo (the cut); on a machine with a
# card per rank each rank takes its own (CUDA_VISIBLE_DEVICES) and the
# backend rule picks nccl. (a) phase 5's first batch, and a copy whose
# rank-1 rows are mostly padding (MH_UNEVEN_LENGTHS valid steps), each
# one REINFORCE update from phase 5's initial params; (b) a two-rank
# TrainingServer fed by an agent of MH_LANES lanes (one epoch a wave, so
# the agent installs every published version) for MH_SERVER_UPDATES
# updates, a collective checkpoint, a resume on both ranks and
# MH_RESUME_UPDATES more; (c) DQN and SAC at their goldens' widths,
# MH_OFF_UPDATES updates on the coordinator's samples.
MH_RANKS = 2
MH_UNEVEN_LENGTHS = (24, 9, 3, 1)
MH_TIMED = 3
MH_LANES = 8
MH_SERVER_UPDATES = 3
MH_RESUME_UPDATES = 2
MH_OFF_UPDATES = 4
MH_OFF_TIMED = 20
MH_OFF_ALGOS = ("DQN", "SAC")
MH_TIMEOUT_S = 420


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
    (``[8, 256, 8, 32]`` bf16 causal), at PPO's minibatch shape
    (``[2, 256, 8, 32]`` bf16 causal, phase 14) and at edge shapes: T = 1, 17, 130
    (f32 and bf16, causal and not), head dim 64 at T = 130, and in bf16,
    causal and not, the tensor-core kernels' tile edges: T = 64 (one whole
    tile), T = 65 (one row past it) and head dim 16; and at the widest head
    dims, [8, T, 4, 128] and [8, T, 2, 256] (T = 256 and 130, f32 and bf16,
    causal and not). Times at the slice's shape, at [8, 256, 4, 128] and at
    [8, 256, 2, 256] (bf16 causal): each kernel alone (on a prescaled q),
    and the whole backward as the learner runs it (``torch.autograd.grad``
    through ``flash_attention``: delta, the prescaled q, K2 and K3) beside
    SDPA's backward; and at PPO's minibatch shape. Returns {"flash_dq":
    ..., "flash_dkv": ...} for the slice's shape, each with the head dim
    128 and 256 measurements under ``"d128"`` and ``"d256"`` and PPO's
    under ``"ppo_minibatch"``."""
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

    B_main, H = LEARNER["traj_per_epoch"], SLICE_ARCH["n_heads"]
    D = SLICE_ARCH["d_model"] // H
    T_main = SLICE_ARCH["max_seq_len"]
    gen = torch.Generator().manual_seed(SEED + 1)
    main_case = (torch.bfloat16, True, T_main, H, D)
    wide_case = (torch.bfloat16, True, T_main, WIDE_H, WIDE_D)
    widest_case = (torch.bfloat16, True, T_main, WIDEST_H, WIDEST_D)
    # A case's optional sixth entry is its batch (B_main otherwise).
    ppo_case = (torch.bfloat16, True, T_main, H, D, PPO_MINIBATCH_ROWS)
    timed = {wide_case: "d128", widest_case: "d256", ppo_case: "ppo_minibatch"}
    dtypes = (torch.bfloat16, torch.float32)
    cases = [main_case, wide_case, widest_case, ppo_case]
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
        dtype, causal, T, H, d, *rows = case
        B = rows[0] if rows else B_main
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
        main[kernel]["head_dims"] = sorted({case[4] for case in cases})
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


def compare_evaluate(host, device, wrap=None) -> float:
    """One ``evaluate`` forward through the kernel against the same forward
    with the plain attention, on the host's current params (``wrap``
    wraps each side's ``evaluate``, as :func:`update_sides`' does its
    update); returns the max abs difference over (logp, entropy, v)."""
    import torch

    from relayrl_tpu_torch.ops.flash import flash_attention_plain

    gen = torch.Generator().manual_seed(SEED)
    obs = torch.randn((LANES, host.arch["max_seq_len"], host.arch["obs_dim"]),
                      generator=gen).to(device)
    act = torch.randint(0, host.arch["act_dim"], obs.shape[:2], generator=gen).to(device)
    plain = copy.deepcopy(host.params)
    for block in plain.layers():
        block.attn_fn = lambda q, k, v: flash_attention_plain(q, k, v, True)[0]
    evaluate = host.policy.evaluate if wrap is None else wrap(host.policy.evaluate)
    with torch.inference_mode():
        got = evaluate(host.params, obs, act)
        want = evaluate(plain, obs, act)
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


def profile_device(fn, n: int, unit: str, cpu: bool = True,
                   warm: bool = True) -> dict | None:
    """Device busy share of ``n`` back-to-back calls of ``fn`` and the
    kernels that take the device time, from ``torch.profiler`` (whose own
    cost lengthens the wall time it is divided by); returns the wall and
    busy ms and the device operations per call (None when the profiler
    saw no device activity). Annotated ranges on
    the device timeline (``Optimizer.step#Adam.step``) span kernels
    counted on their own, so they are left out. ``cpu=False`` records the
    device activity alone (a call of tens of thousands of operations
    otherwise takes a minute to summarize). ``warm=False`` skips the
    unprofiled warm-up call, for a caller that has just run ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    activities = ([ProfilerActivity.CPU] if cpu else []) + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
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


def plain_flash(q, k, v):
    """Causal attention through the flash kernels' plain versions (the
    same function as K1-K3, without them)."""
    from relayrl_tpu_torch.ops.flash import flash_attention_plain

    return flash_attention_plain(q, k, v, True)[0]


def dense_causal(q, k, v):
    """Causal attention through the dense softmax (a second plain
    arithmetic for phase 9's noise estimate)."""
    from relayrl_tpu_torch.ops.attention import dense_attention

    return dense_attention(q, k, v, causal=True)


def plain_flash_f64(q, k, v):
    """K1's plain version in float64, rounded back (a third)."""
    from relayrl_tpu_torch.ops.flash import flash_attention_plain

    return flash_attention_plain(q.double(), k.double(), v.double(), True)[0].to(q.dtype)


NOISE_ATTENTIONS = (dense_causal, plain_flash_f64)


def build_learner(device, workdir: Path, arch: dict = SLICE_ARCH,
                  algorithm: str = "REINFORCE", hp: dict | None = None):
    """The port's ``algorithm`` (REINFORCE with ``LEARNER`` by default)
    at ``arch`` (the slice's by default), on ``device``; the compute dtype
    comes from the config's ``learner.precision`` (``arch["precision"]``),
    as in the JAX package."""
    from relayrl_tpu_torch.algorithms import build_algorithm
    from relayrl_tpu_torch.envs import RecallEnv

    workdir.mkdir(parents=True, exist_ok=True)
    config = workdir / "relayrl_config.json"
    config.write_text(json.dumps(
        {"learner": {"precision": arch["precision"]}}))
    env = RecallEnv(LEARNER_HORIZON, N_CUES)
    overrides = {k: v for k, v in arch.items()
                 if k not in ("kind", "has_critic", "precision")}
    algo = build_algorithm(
        algorithm, env_dir=str(workdir), config_path=str(config),
        obs_dim=int(env.observation_space.shape[0]),
        act_dim=int(env.action_space.n), device=device,
        model_kind=arch["kind"], seed=SEED, seed_salt=0,
        **overrides, **(LEARNER if hp is None else hp))
    for key, value in arch.items():
        if algo.arch[key] != value:
            raise AssertionError(f"learner arch {key}={algo.arch[key]!r}, "
                                 f"expected {value!r}")
    return algo


def update_parts(algo, policy, params, idx_sets=None, **overrides):
    """One update of ``algo``'s kind through ``policy`` (the card's or the
    CPU's) from ``params`` with fresh Adam state: ``(state, update,
    steps)``, where ``update(state, batch)`` returns ``(state, metrics)``
    and ``steps(name)`` is a parameter's (Adam steps at most, learning
    rate) in it. PPO runs on ``idx_sets``; ``overrides`` replace its
    hyperparameters."""
    from relayrl_tpu_torch.algorithms.reinforce import (
        ReinforceState,
        make_optimizers,
        make_reinforce_update,
    )

    name = algo.ALGO_NAME
    if name == "REINFORCE":
        state = ReinforceState(params, *make_optimizers(params, algo.pi_lr, algo.vf_lr))
        update = make_reinforce_update(policy, algo.train_vf_iters, algo.gamma,
                                       algo.lam, algo.with_baseline)
        return state, update, lambda n: ((algo.train_vf_iters, algo.vf_lr)
                                         if n.startswith("vf") else (1, algo.pi_lr))
    state = algo.fresh_state(params)
    if name == "IMPALA":
        return state, algo.make_update(policy), lambda n: (1, algo.lr)
    ppo = algo.make_update(policy, **overrides)
    return (state, lambda st, batch: ppo(st, batch, idx_sets),
            lambda n: (len(idx_sets), algo.vf_lr if n.startswith("vf") else algo.pi_lr))


def update_sides(algo, params0, batch, device, plain_attn, wrap=None,
                 idx_sets=None) -> tuple[dict, object]:
    """The learner's first update through the kernels and the same update
    with every block's attention replaced by ``plain_attn`` (which runs
    the kernels' plain versions), both from ``params0`` with fresh Adam
    state (:func:`update_parts`; PPO on ``idx_sets``); ``wrap`` wraps the
    update (the sharded update of phase 7). Returns ``({"kernel": (params,
    metrics), "plain": ...}, steps)``."""
    import torch

    from relayrl_tpu_torch.algorithms.onpolicy import read_metrics
    from relayrl_tpu_torch.weights import logical_state

    sides = {}
    for side in ("kernel", "plain"):
        params = copy.deepcopy(params0)
        if side == "plain":
            for block in params.layers():
                block.attn_fn = plain_attn
        state, update, steps = update_parts(algo, algo.policy, params, idx_sets)
        if wrap is not None:
            update = wrap(update)
        state, metrics = update(state, {key: torch.as_tensor(val, device=device)
                                        for key, val in batch.items()})
        # By logical name: a state placed on a mesh reads its parameters
        # whole.
        sides[side] = (logical_state(state.params), read_metrics(metrics))
    return sides, steps


def compare_update(algo, params0, batch, device, plain_attn, wrap=None,
                   idx_sets=None) -> dict:
    """:func:`update_sides` held to phase 5's bars (:func:`hold_update`).
    Returns the largest metric and parameter differences."""
    sides, steps = update_sides(algo, params0, batch, device, plain_attn, wrap,
                                idx_sets)
    return hold_update(sides["kernel"], sides["plain"], params0, steps)


def hold_update(got_side, want_side, params0, steps,
                what: str = "kernel vs plain") -> dict:
    """One update's ``(params, metrics)`` against another's from the same
    ``params0``, at phase 5's bars: metrics within ``UPDATE_METRIC_TOL`` x
    max(1, |m|), every parameter within twice its Adam step bound, the
    mean |difference| within ``UPDATE_MEAN_DIFF_SHARE`` of the mean
    movement. Returns the largest metric and parameter differences."""
    (got, got_m), (want, want_m) = got_side, want_side
    metric_err = 0.0
    for key, value in want_m.items():
        err = abs(got_m[key] - value)
        if not err <= UPDATE_METRIC_TOL * max(1.0, abs(value)):
            raise AssertionError(f"update metric {key} ({what}): {got_m[key]} vs "
                                 f"{value}")
        metric_err = max(metric_err, err)
    start = dict(params0.named_parameters())
    diff_sum = moved_sum = 0.0
    param_err = 0.0
    for name, w in want.items():
        n_steps, lr = steps(name)
        bound = 2 * n_steps * lr
        err = (got[name] - w).abs().max().item()
        if not err <= bound:
            raise AssertionError(f"update param {name}: {what} {err} "
                                 f"above {bound}")
        param_err = max(param_err, err)
        diff_sum += (got[name] - w).abs().mean().item()
        moved_sum += (w - start[name]).abs().mean().item()
    share = diff_sum / moved_sum
    if not share <= UPDATE_MEAN_DIFF_SHARE:
        raise AssertionError(f"update params: mean |difference| ({what}) is "
                             f"{share:.4f} of the mean movement")
    return {"metric_err": metric_err, "param_err": param_err,
            "mean_diff_share": share, "metrics": got_m}


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
    for block in flash.layers():
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


@contextlib.contextmanager
def routes_from_window(changes: dict):
    """Pins the cached decode's MoE routes to the window step's (see
    :func:`pinned_routes` for why a bar needs that). Yields a dict whose
    ``"mode"`` the caller sets per actor step: ``"record"`` logs the window
    step's top-k indices per MoE layer, ``"replay"`` (with ``"t"``, the
    position) gives each later MoE call the logged layer's routes, in call
    order: the same rows where the call has as many tokens as the window
    (a prefill, a rolled window step), else row ``t`` (a cached step).
    ``changes`` counts the tokens at positions up to ``t`` whose own
    top-k would have differed (``"changed"`` of ``"tokens"``)."""
    from relayrl_tpu_torch.models import moe

    own_top_k = moe.top_k_stable
    pin = {"mode": None, "t": 0, "log": [], "at": 0}

    def top_k(values, k):
        vals, idx = own_top_k(values, k)
        if pin["mode"] == "record":
            pin["log"].append(idx)
        elif pin["mode"] == "replay":
            window = pin["log"][pin["at"] % len(pin["log"])]
            pin["at"] += 1
            t = pin["t"]
            pinned = window if len(idx) == len(window) else window[t:t + len(idx)]
            mine = idx[:t + 1].sort(-1)[0] != pinned[:t + 1].sort(-1)[0]
            changes["changed"] += int(mine.any(-1).sum())
            changes["tokens"] += len(mine)
            return values.gather(-1, pinned), pinned
        return vals, idx

    moe.top_k_stable = top_k
    try:
        yield pin
    finally:
        moe.top_k_stable = own_top_k


def check_cached_decode(device, arch: dict | None = None,
                        episodes: int = CACHED_EPISODES,
                        pin_routes: bool = False) -> dict:
    """The transformer's KV-cache decode path on the card, at the serving
    slice's arch (``__graft_entry__.entry()``'s: d_model 256, 4 layers, 8
    heads, T 256, bf16): a ``PolicyActor`` serving through the cache and one
    serving through the window, from one bundle and seed, act on the same
    ``CACHED_EPISODES`` ``RecallEnv(HORIZON)`` episodes (longer than the
    window, so it rolls), with a hot swap at step ``CACHED_SWAP_AT`` of the
    first. Before the window rolls, at every position, the cached step's
    log-probability of a fixed action and its v match the window step's at
    the arch precision's bar (bf16: 3e-2 of the largest |value|, f32:
    2e-5 of it); the swap costs exactly one
    prefill; the cached path launches no flash kernel (the window path n_layers
    - 1 per step) and serves every step until the window rolls, the window
    path after. ``arch`` (default: the serving slice's) may be a MoE
    transformer, whose window step runs its final block whole (n_layers K1
    per step); with ``pin_routes`` the window actor steps first and the
    cached one takes its MoE routes (:func:`routes_from_window`). Returns
    the errors, the actions' agreement rate, the routes pinned and the ms
    per env step of both paths."""
    import numpy as np
    import torch

    from relayrl_tpu_torch.envs import RecallEnv
    from relayrl_tpu_torch.models import build_policy
    from relayrl_tpu_torch.runtime import PolicyActor
    from relayrl_tpu_torch.types import ModelBundle
    from relayrl_tpu_torch.weights import params_to_jax

    arch = slice_arch() if arch is None else arch
    policy = build_policy(arch, device)
    v1, v2 = (ModelBundle(version, arch, params_to_jax(policy.init_params(
        torch.Generator().manual_seed(SEED + version)))) for version in (1, 2))
    order = ("window", "cached") if pin_routes else ("cached", "window")
    actors = {side: PolicyActor(v1, seed=SEED, device=device, use_kv_cache=side == "cached")
              for side in order}
    cached = actors["cached"]
    logits = {side: [] for side in actors}
    steps = _spy_calls(cached, "_cached_fn", logits["cached"])
    window_steps = _spy_calls(cached, "_window_fn")
    prefills = _spy_calls(cached, "_prefill_fn")
    _spy_calls(actors["window"], "_window_fn", logits["window"])
    context = arch["max_seq_len"]
    env = RecallEnv(HORIZON, N_CUES)
    n_layers = arch["n_layers"]
    window_k1 = n_layers - (arch["kind"] == "transformer_discrete")
    fixed = 0  # the action whose log-probability is compared
    diffs = {"logp": [], "v": []}
    wants = {"logp": [], "v": []}
    seconds = {side: 0.0 for side in actors}
    agree = compared = total_k1 = 0
    changes = {"changed": 0, "tokens": 0}
    pinning = routes_from_window(changes) if pin_routes else contextlib.nullcontext()
    with pinning as pin:
        for episode in range(episodes):
            obs, _ = env.reset(seed=SEED + episode)
            for t in range(HORIZON):
                if episode == 0 and t == CACHED_SWAP_AT:
                    n_prefills = len(prefills)
                    if not all(actor.maybe_swap(v2) for actor in actors.values()):
                        raise AssertionError("hot swap refused")
                records = {}
                for side, actor in actors.items():
                    if pin_routes:
                        if side == "window":
                            pin["log"].clear()
                        pin.update(mode="record" if side == "window" else "replay", t=t, at=0)
                    zero_flash_counts()
                    t0 = time.perf_counter()
                    records[side] = actor.request_for_action(obs)
                    torch.cuda.synchronize()
                    elapsed = time.perf_counter() - t0
                    launches = flash_counts()
                    total_k1 += launches[0]
                    want = (0 if side == "cached" and t < context else window_k1, 0, 0)
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
    bars = {key: TOLERANCE[arch["precision"]] * max(wants[key]) for key in wants}
    rolled = episodes * (HORIZON - context)
    if not all(math.isfinite(errs[key]) and errs[key] <= bars[key] for key in errs):
        raise AssertionError(f"cached vs window step: max abs errs {errs} above {bars}")
    if (len(steps) != episodes * context or len(window_steps) != rolled
            or len(prefills) != 1):
        raise AssertionError(f"cached steps {len(steps)}, window steps {len(window_steps)}, "
                             f"prefills {len(prefills)}")
    return {"errs": errs, "bars": bars, "agreement": agree / compared, "compared": compared,
            "prefills": len(prefills), "cached_ms": 1e3 * seconds["cached"] / compared,
            "window_ms": 1e3 * seconds["window"] / compared, "launches": total_k1,
            "route_changes": changes}


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


def compare_update_to_cpu(algo, params0, batch, idx_sets=None, plain_attn=None,
                          noise_attns=(), **overrides) -> dict:
    """The learner's update from ``params0`` on ``batch`` on its device
    against the same update on the CPU, both with fresh Adam state
    (:func:`update_parts`: REINFORCE, IMPALA, or PPO on ``idx_sets`` with
    ``overrides``), in f32: metrics within ``MLP_METRIC_RTOL`` plus
    ``MLP_METRIC_ATOL``, every parameter element within ``MLP_PARAM_ATOL``,
    except where both sides take Adam's normalized step on rounding noise.
    An element whose RMS gradient on the CPU fell below ``ADAM_FLOOR`` at
    some step is held to Adam's step bound, the learning rate per step
    taken. The key third of a transformer's qkv bias has a zero gradient in
    exact arithmetic (a softmax does not change when one constant is added
    to all of a query's scores), so each side steps on its own noise: each
    side's move from ``params0`` is held to the step bound (with
    ``KEY_BIAS_SLACK``), as tests/test_torch_reinforce.py holds the JAX
    package; the card's gradient there is reported beside the q and v
    thirds' (``key_grad``, ``qv_grad``).

    With ``plain_attn`` (the recall learner of phase 9) the same update
    also runs on the card with every block's attention replaced by it, and
    an element outside Adam's floor passes when its card-vs-CPU difference
    is within the bar or within ``PLAIN_NOISE_FACTOR`` times the
    plain-vs-CPU difference there, so the kernels are held to what the same
    arithmetic without them gives. With ``noise_attns`` too (more plain
    attentions), the update also runs through each of them on the card, and
    each of ``DELTA_METRICS`` is held to the larger of its bar and
    ``PLAIN_NOISE_FACTOR`` times the largest card-vs-CPU difference among
    the plain sides (``delta_bars``; ``delta_over_bar`` says whether the bar
    alone would have failed it). Returns the largest differences, the
    elements below the floor, the largest difference among them, the
    elements that passed by the relative rule alone (with the largest such
    difference), whether the plain side alone would miss the bars, the key
    bias's largest move over its bound, the card's metrics, and each of
    ``ELEMENT_RULES``' first failing element or None (``rule_fail``; a
    failure's message carries them too)."""
    import torch

    from relayrl_tpu_torch.algorithms.onpolicy import read_metrics
    from relayrl_tpu_torch.models import build_policy
    from relayrl_tpu_torch.weights import params_to_jax

    sides = {}
    least_rms = {}  # the CPU side's smallest sqrt(v_hat) per element over its steps
    most_rms = {}  # the card side's largest

    def track_rms(store, pick):
        def hook(opt, args, kwargs):
            beta2 = opt.param_groups[0]["betas"][1]
            for p, st in opt.state.items():
                rms = st["exp_avg_sq"].sqrt() / math.sqrt(1 - beta2 ** float(st["step"]))
                store[p] = pick(store[p], rms) if p in store else rms
        return hook

    key_grads = {}
    # The CPU side last: the checks below read its parameters and Adam.
    plains = {} if plain_attn is None else {"plain": plain_attn}
    plains.update({f"noise{i}": attn for i, attn in enumerate(noise_attns)})
    for side in ("card", *plains, "cpu"):
        policy = algo.policy if side != "cpu" else build_policy(algo.arch, "cpu")
        params = policy.load_params(params_to_jax(params0))
        if side in plains:
            for block in params.layers():
                block.attn_fn = plains[side]
        state, update, _ = update_parts(algo, policy, params, idx_sets, **overrides)
        opts = [opt for opt in vars(state).values()
                if isinstance(opt, torch.optim.Optimizer)]
        if side not in plains:
            hook = (track_rms(least_rms, torch.minimum) if side == "cpu"
                    else track_rms(most_rms, torch.maximum))
            for opt in opts:
                opt.register_step_post_hook(hook)
        state, metrics = update(state, {k: torch.as_tensor(v, device=policy.device)
                                        for k, v in batch.items()})
        sides[side] = ({name: p.detach().cpu() for name, p in state.params.named_parameters()},
                       read_metrics(metrics))
        thirds = [most_rms[p].cpu().view(3, -1) for name, p in state.params.named_parameters()
                  if side == "card" and name.endswith("qkv.bias") and p in most_rms]
        if thirds:
            key_grads = {"key_grad": max(t[1].max().item() for t in thirds),
                         "qv_grad": torch.cat([t[[0, 2]].flatten() for t in thirds])
                         .median().item()}
    (got, got_m), (want, want_m) = sides["card"], sides["cpu"]
    plain, plain_m = sides.get("plain", (None, None))
    start = {name: p.detach().cpu() for name, p in params0.named_parameters()}
    # Adam's step bound per parameter: its learning rate times its steps.
    step_bound = {p: opt.param_groups[0]["lr"] * float(opt.state[p]["step"])
                  for opt in opts for p in opt.param_groups[0]["params"]
                  if p in opt.state}
    metric_err = param_err = floor_err = relative_err = kernel_err = plain_err = 0.0
    key_moved = 0.0  # the key bias's largest move, over its step bound
    n_floored = n_relative = 0
    plain_over_bar = delta_over_bar = False
    samples = [sides[side][1] for side in plains]
    delta_bars, delta_errs = {}, {}
    metric_fail = None  # raised after the elements, so every rule's verdict is known
    for key, value in want_m.items():
        err = abs(got_m[key] - value)
        bar = MLP_METRIC_RTOL * abs(value) + MLP_METRIC_ATOL
        if plain_m is not None:
            plain_over_bar |= not abs(plain_m[key] - value) <= bar
        if key in DELTA_METRICS and len(samples) > 1:
            delta_over_bar |= not err <= bar
            bar = max(bar, PLAIN_NOISE_FACTOR * max(abs(m[key] - value) for m in samples))
            delta_bars[key], delta_errs[key] = bar, err
        if not err <= bar and metric_fail is None:
            metric_fail = (f"update metric {key}: card {got_m[key]} vs cpu {value} "
                           f"(bar {bar:.3e}" + (f"; plain sides vs cpu "
                           f"{[abs(m[key] - value) for m in samples]})"
                           if key in delta_bars else ")"))
        metric_err = max(metric_err, err)
    # Each ELEMENT_RULES rule's first failing element (None: it passes).
    rule_fail = {rule: None for rule in ELEMENT_RULES} if plain is not None else {}
    element_fail = None
    for name, p in state.params.named_parameters():
        diff = (got[name] - want[name]).abs()
        noise = least_rms[p] < ADAM_FLOOR
        ok = torch.where(noise, diff <= step_bound[p], diff <= MLP_PARAM_ATOL)
        key = torch.zeros_like(noise)
        if name.endswith("qkv.bias"):
            d = diff.numel() // 3
            key[d:2 * d] = True
            moved = torch.maximum((got[name] - start[name]).abs(),
                                  (want[name] - start[name]).abs())
            ok[key] = moved[key] <= step_bound[p] * KEY_BIAS_SLACK
            key_moved = max(key_moved, moved[key].max().item() / step_bound[p])
            noise = noise & ~key
        real = ~noise & ~key
        if plain is not None:
            plain_diff = (plain[name] - want[name]).abs()
            sides_diff = torch.stack([(sides[side][0][name] - want[name]).abs()
                                      for side in plains]).amax(0)
            refs = (plain_diff, sides_diff, sides_diff.where(real, 0.0).max())
            held = ~ok & real
            for rule, ref in zip(ELEMENT_RULES, refs):
                passes = ok | (held & (diff <= PLAIN_NOISE_FACTOR * ref))
                if rule_fail[rule] is None and not bool(passes.all()):
                    i = int(torch.nonzero(~passes.flatten())[0])
                    rule_fail[rule] = (f"{name} element {i}: card vs cpu "
                                       f"{diff.flatten()[i].item():.3e}, reference "
                                       f"{ref.expand_as(diff).flatten()[i].item():.3e}")
            passed = held & (diff <= PLAIN_NOISE_FACTOR * plain_diff)
            n_relative += int(passed.sum())
            relative_err = max(relative_err, diff.where(passed, 0.0).max().item())
            ok |= passed
        if not bool(ok.all()) and element_fail is None:
            i = int(torch.nonzero(~ok.flatten())[0])
            rule = ("key bias, each side's move within the step bound "
                    f"{step_bound[p]}" if key.flatten()[i] else
                    f"noise, step bound {step_bound[p]}" if noise.flatten()[i] else
                    "bar" if plain is None else
                    f"bar; plain attention vs cpu {plain_diff.flatten()[i].item()}")
            element_fail = (f"update param {name}: card vs cpu {diff.flatten()[i].item()} "
                            f"at element {i} ({rule})")
        kernel_err = max(kernel_err, diff.where(real, 0.0).max().item())
        if plain is not None:
            plain_err = max(plain_err, plain_diff.where(real, 0.0).max().item())
        param_err = max(param_err, diff.where(real & (diff <= MLP_PARAM_ATOL), 0.0)
                        .max().item())
        floor_err = max(floor_err, diff.where(noise, 0.0).max().item())
        n_floored += int(noise.sum())
    if metric_fail or element_fail:
        raise AssertionError("; ".join(m for m in (metric_fail, element_fail) if m) + "".join(
            f"; rule '{rule}': {fail or 'passes'}" for rule, fail in rule_fail.items()))
    plain_over_bar |= plain_err > MLP_PARAM_ATOL
    return {"metric_err": metric_err, "param_err": param_err, "n_floored": n_floored,
            "floor_err": floor_err, "n_relative": n_relative,
            "relative_err": relative_err, "rule_fail": rule_fail, "kernel_err": kernel_err,
            "plain_err": plain_err, "plain_over_bar": plain_over_bar,
            "delta_bars": delta_bars, "delta_errs": delta_errs,
            "delta_over_bar": delta_over_bar,
            "key_moved": key_moved, **key_grads, "metrics": got_m}


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
    :func:`compare_update_to_cpu` with its noise-relative rule: the plain
    attention on the card is the third side)."""
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
                                epoch_batches(runner.algorithm, episodes, 1)[0],
                                plain_attn=plain_flash, noise_attns=NOISE_ATTENTIONS)
    return {"per_update": per_update, "launches": launches, "steps": steps,
            "cached_steps": len(cached_steps),
            "head_dim": hp["d_model"] // hp["n_heads"], "episodes": len(result["returns"]),
            "avg_return": result["avg_return_last_window"], **cmp}


def recall_sweep(device, workdir: Path, salts: range) -> int:
    """Phase 9's recall comparison alone, over ``seed_salt`` in ``salts``
    (the learner's params and sampling differ with each): the first update
    through the kernels on the card, through the plain attention on the
    card, and on the CPU, from the same params on the same batch
    (:func:`compare_update_to_cpu` with ``plain_flash`` and
    ``NOISE_ATTENTIONS``, as phase 9 runs it). Prints per salt the largest
    difference outside Adam's floor of each card side against the CPU, the
    elements that passed by the noise-relative rule alone, the
    ``DELTA_METRICS``' differences beside their noise bars, and the key
    bias's gradient on the card beside the q and v thirds' and its largest
    move over the step bound; then how many salts fail phase 9's
    criterion, how many the bar alone would fail on each side, and how
    many the metric bar alone would fail on ``DELTA_METRICS``. Gates
    nothing; returns 0."""
    import io

    from relayrl_tpu_torch.envs import RecallEnv
    from relayrl_tpu_torch.examples.train_memory import recall_hyperparams
    from relayrl_tpu_torch.runtime import LocalRunner

    hp = recall_hyperparams("transformer", RECALL_HORIZON, "flash")
    failed = {"noise-relative": [], "bar alone, kernels": [], "bar alone, plain": [],
              "DeltaLoss at the metric bar alone": [],
              **{f"rule '{rule}'": [] for rule in ELEMENT_RULES}}
    key = {"key_grad": 0.0, "qv_grad": math.inf, "key_moved": 0.0}
    for salt in salts:
        runner = LocalRunner(RecallEnv(horizon=RECALL_HORIZON), "REINFORCE",
                             config_path=_local_config(workdir / str(salt)),
                             env_dir=str(workdir / str(salt)), seed=0, device=device,
                             **{**hp, "seed_salt": salt})
        algo = runner.algorithm
        params0 = copy.deepcopy(algo.state.params)
        episodes = []
        ingest = algo.receive_trajectory
        algo.receive_trajectory = lambda a: (episodes.append(a), ingest(a))[1]
        with contextlib.redirect_stdout(io.StringIO()):  # the epoch log
            runner.train(epochs=1)
        batch = epoch_batches(algo, episodes, 1)[0]
        try:
            cmp = compare_update_to_cpu(algo, params0, batch, plain_attn=plain_flash,
                                        noise_attns=NOISE_ATTENTIONS)
        except AssertionError as exc:
            failed["noise-relative"].append(salt)
            failed["bar alone, kernels"].append(salt)
            if any(f"metric {k}" in str(exc) for k in DELTA_METRICS):
                failed["DeltaLoss at the metric bar alone"].append(salt)
            for rule in ELEMENT_RULES:
                if "update metric" in str(exc) or f"rule '{rule}': passes" not in str(exc):
                    failed[f"rule '{rule}'"].append(salt)
            print(f"[recall-sweep] salt {salt}: FAILS {exc}", flush=True)
            continue
        if cmp["n_relative"]:
            failed["bar alone, kernels"].append(salt)
        if cmp["plain_over_bar"]:
            failed["bar alone, plain"].append(salt)
        if cmp["delta_over_bar"]:
            failed["DeltaLoss at the metric bar alone"].append(salt)
        for rule, fail in cmp["rule_fail"].items():
            if fail:
                failed[f"rule '{rule}'"].append(salt)
        key = {"key_grad": max(key["key_grad"], cmp["key_grad"]),
               "qv_grad": min(key["qv_grad"], cmp["qv_grad"]),
               "key_moved": max(key["key_moved"], cmp["key_moved"])}
        print(f"[recall-sweep] salt {salt}: outside Adam's floor, max card-vs-cpu diff "
              f"kernels {cmp['kernel_err']:.3e}, plain {cmp['plain_err']:.3e}; "
              f"{cmp['n_relative']} element(s) passed by the relative rule alone (max "
              f"{cmp['relative_err']:.3e}); max metric diff {cmp['metric_err']:.3e}; "
              + ", ".join(f"{k} {cmp['delta_errs'][k]:.3e} (bar {cmp['delta_bars'][k]:.3e})"
                          for k in cmp["delta_bars"])
              + f"; key "
              f"bias: card gradient {cmp['key_grad']:.3e} (q and v thirds' median "
              f"{cmp['qv_grad']:.3e}), largest move {cmp['key_moved']:.6f} x the step bound",
              flush=True)
    n = len(salts)
    print("[recall-sweep] salts failing, of " + f"{n}: " + "; ".join(
        f"{rule} {len(bad)} {bad}" for rule, bad in failed.items()), flush=True)
    print(f"[recall-sweep] key bias over the passing salts: largest card gradient "
          f"{key['key_grad']:.3e}, smallest q and v median {key['qv_grad']:.3e}, largest "
          f"move {key['key_moved']:.6f} x the step bound", flush=True)
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class ChaosServer:
    """The port's ``examples/chaos_server.py`` in a process of its own,
    started with ``subprocess`` (never a fork of this CUDA process), its
    output kept in ``log``; :meth:`status` reads its status file."""

    def __init__(self, root: Path, cfg: dict, log: Path, env: dict | None = None):
        import os

        self.cfg, self.log = cfg, log
        env = dict(os.environ, PYTHONPATH=str(root), **(env or {}))
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


def zmq_addrs() -> tuple[dict, dict]:
    """Three free localhost ports as a ZMQ server's bind addresses and its
    agents' addresses."""
    ports = [_free_port() for _ in range(3)]
    server = {"agent_listener_addr": f"tcp://127.0.0.1:{ports[0]}",
              "trajectory_addr": f"tcp://127.0.0.1:{ports[1]}",
              "model_pub_addr": f"tcp://127.0.0.1:{ports[2]}"}
    agent = {"agent_listener_addr": server["agent_listener_addr"],
             "trajectory_addr": server["trajectory_addr"],
             "model_sub_addr": server["model_pub_addr"]}
    return server, agent


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
    server_addrs, agent_addrs = zmq_addrs()
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
           # Typed nacks exist only on the grpcio servicer: the native C++
           # gRPC server acks before Python sees a send.
           "native_grpc": False,
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
        status = server.wait(lambda s: True, "the server to come up")
        if status["transport"] != "GrpcServerTransport":
            raise AssertionError(f"server transport {status['transport']}")
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


class RelayProcess:
    """``python -m relayrl_tpu_torch.relay`` in a process of its own (the
    relay takes ``cfg`` as its ``--json`` kwargs and ``flags`` as further
    arguments), started in ``workdir``, its output appended to
    ``relay.log``; returns once it is serving."""

    def __init__(self, root: Path, cfg: dict, workdir: Path, tag: str,
                 timeout_s: float = 120.0, flags: tuple = ()):
        import os

        self.ready = workdir / f"relay_{tag}_ready"
        self.stop_file = workdir / "relay_stop"
        self.result = workdir / f"relay_{tag}.json"
        self.stop_file.unlink(missing_ok=True)
        self.log = workdir / "relay.log"
        self._out = open(self.log, "ab")
        env = dict(os.environ, PYTHONPATH=str(root))
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "relayrl_tpu_torch.relay",
             "--json", json.dumps(cfg), "--ready-file", str(self.ready),
             "--stop-file", str(self.stop_file),
             "--result-path", str(self.result), *flags],
            cwd=str(workdir), env=env, stdout=self._out,
            stderr=subprocess.STDOUT)
        deadline = time.monotonic() + timeout_s
        while not self.ready.exists():
            if self.proc.poll() is not None or time.monotonic() > deadline:
                self.kill()
                raise AssertionError(f"relay {tag} never came up:\n"
                                     f"{self.log.read_bytes()[-3000:].decode(errors='replace')}")
            time.sleep(0.05)

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)
        if not self._out.closed:
            self._out.close()

    def close(self, timeout_s: float = 60.0) -> dict:
        """Stop through the stop file (the relay flushes its spool
        upstream first) and return its result: stats and telemetry."""
        self.stop_file.write_text("stop")
        try:
            self.proc.wait(timeout=timeout_s)
        finally:
            self.kill()
        return json.loads(self.result.read_text())


def _progress_rows(server_dir: Path) -> list[dict]:
    """The rows of the epoch log(s) a server wrote under ``server_dir``."""
    rows = []
    for path in sorted(server_dir.glob("logs/**/progress.txt")):
        lines = path.read_text().splitlines()
        if not lines:
            continue
        header = lines[0].split("\t")
        rows += [dict(zip(header, line.split("\t"))) for line in lines[1:]]
    return rows


def async_fleet(device, root: Path, workdir: Path, learned: dict) -> dict:
    """Phase 13: IMPALA on the flagship transformer in a chaos_server
    process over the native plane, fed by agent A through a relay process
    (native upstream, zmq downstream) and by agent B straight over native;
    the relay SIGKILL drill. Before the fleet: IMPALA's first update on
    phase 5's first batch through the kernels against the plain attention
    (phase 5's bars; behavior log-probs from the f32 model, see the
    comment there), and at f32 against the CPU, and its in-process update
    time and device busy share. Gates: the server's K1/K2/K3 launches per
    update (one evaluate and one backward: n_layers each), the agents' K1
    per dispatch, every trajectory decoded by the native codec and none
    by Python, each leaf's sequence accepted exactly once through the
    kill (accepted == max_seq == sent, contiguous, trained == sent), A's
    and B's params sha256-equal to the publish, A installing a version
    past the kill, a resync from A served from the relay's cached
    keyframe, RhoMean and KL finite in every update's log row, no learner
    error and a clean guardrail book. Measures the native decode against
    the Python decode on B's payloads and the relay hop's added install
    latency (A's install minus B's, per version)."""
    import shutil
    import statistics

    import torch

    from relayrl_tpu_torch.envs import RecallEnv, SyncVectorEnv
    from relayrl_tpu_torch.ops.flash import flash_attention_plain
    from relayrl_tpu_torch.runtime.agent import VectorAgent
    from relayrl_tpu_torch.runtime.vector_actor import run_vector_gym_loop
    from relayrl_tpu_torch.types.columnar import DecodedTrajectory, NativeDecoder
    from relayrl_tpu_torch.types.trajectory import deserialize_actions
    from relayrl_tpu_torch.weights import params_to_jax, tree_digest

    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    batch = learned["batch"]

    # The first update, in this process. V-trace's truncated ratios
    # min(1, exp(logp - behavior)) multiply over up to 255 steps, so the
    # update turns the distance between a side's log-probs and the
    # behavior's into a systematic shift: phase 5's actors took the
    # behavior log-probs through K1, and the plain attention's bf16 path
    # sits further from them than the kernels' does. The kernels-vs-plain
    # comparison therefore takes its behavior log-probs from the f32 model
    # at the same params, which neither side computes; the update on the
    # actors' log-probs is reported beside it (not gated).
    plain_attn = lambda q, k, v: flash_attention_plain(q, k, v, True)[0]  # noqa: E731
    algo = build_learner(device, workdir / "learner", algorithm="IMPALA", hp=IMPALA_HP)
    f32 = build_learner(device, workdir / "learner_f32",
                        arch={**SLICE_ARCH, "precision": "float32"},
                        algorithm="IMPALA", hp=IMPALA_HP)
    cpu = compare_update_to_cpu(f32, copy.deepcopy(f32.state.params), batch)
    with torch.no_grad():
        tb = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        logp32, _, _ = f32.policy.evaluate(f32.state.params, tb["obs"], tb["act"],
                                           tb["act_mask"])
    f32_behavior = dict(batch, logp=(logp32.float() * tb["valid"]).cpu().numpy())
    del f32, tb
    zero_flash_counts()
    plain = compare_update(algo, copy.deepcopy(algo.state.params), f32_behavior,
                           device, plain_attn)
    first_counts = flash_counts()
    actors, _ = update_sides(algo, copy.deepcopy(algo.state.params), batch, device,
                             plain_attn)
    on_actors = {key: (actors["kernel"][1][key], actors["plain"][1][key])
                 for key in ("LossPi", "LossV", "RhoMean")}
    for where, metrics in (("kernels", plain["metrics"]), ("card f32", cpu["metrics"])):
        if not all(math.isfinite(metrics[k]) for k in ("RhoMean", "KL")):
            raise AssertionError(f"IMPALA first update ({where}): {metrics}")
    seconds = []
    for _ in range(4):
        t0 = time.perf_counter()
        algo.train_on_batch(batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    update_ms = 1e3 * sum(seconds[1:]) / len(seconds[1:])
    profile_device(lambda: algo.train_on_batch(batch), 1, "update")
    del algo

    # The fleet.
    port = _free_port()
    server_addr = f"127.0.0.1:{port}"
    downstream, a_addrs = zmq_addrs()
    env = RecallEnv(LEARNER_HORIZON, N_CUES)
    arch = SLICE_ARCH
    hyperparams = {"model_kind": arch["kind"], "seed": SEED, "seed_salt": 0,
                   **{k: v for k, v in arch.items()
                      if k not in ("kind", "has_critic", "precision")},
                   **IMPALA_HP}
    server_dir = workdir / "server"
    cfg = {"algorithm": "IMPALA",
           "obs_dim": int(env.observation_space.shape[0]),
           "act_dim": int(env.action_space.n), "hyperparams": hyperparams,
           "device": str(device), "scratch": str(server_dir),
           "server_type": "native", "bind_addr": server_addr,
           "config": {"learner": {"precision": arch["precision"]}},
           "digests": True, "status_path": str(workdir / "status.json"),
           "profile": {"after": 1, "updates": 2,
                       "path": str(workdir / "profile.json")}}
    relay_config = workdir / "relay_config.json"
    relay_config.write_text(json.dumps({}))
    relay_cfg = {"config_path": str(relay_config), "name": "fleet",
                 "upstream_type": "native",
                 "upstream": {"server_addr": server_addr, "probe": False},
                 "downstream_type": "zmq", "downstream": downstream,
                 "spool_dir": str(workdir / "relay_spool"),
                 "batch_max": 4, "batch_linger_ms": 5.0}
    agent_config = workdir / "agent_config.json"
    agent_config.write_text(json.dumps({}))
    n_layers = arch["n_layers"]
    per_update = (n_layers, n_layers, n_layers)
    per_epoch = IMPALA_HP["traj_per_epoch"]

    server = ChaosServer(root, cfg, workdir / "server.log")
    relay = None
    agents = {}
    try:
        status = server.wait(lambda s: True, "the server to come up",
                             timeout_s=FLEET_TIMEOUT_S)
        if status["transport"] != "NativeServerTransportImpl":
            raise AssertionError(f"server transport {status['transport']}")
        relay = RelayProcess(root, relay_cfg, workdir, "primary")
        common = {"config_path": str(agent_config), "seed": SEED,
                  "probe": False, "device": device}
        agents["A"] = VectorAgent(num_envs=DIST_LANES, identity="relayed",
                                  server_type="zmq",
                                  model_path=str(workdir / "client_a.rlx"),
                                  **common, **a_addrs)
        agents["B"] = VectorAgent(num_envs=FLEET_LANES_B, identity="direct",
                                  server_type="native", server_addr=server_addr,
                                  model_path=str(workdir / "client_b.rlx"),
                                  **common)
        kinds = {n: type(a.transport).__name__ for n, a in agents.items()}
        if kinds != {"A": "ZmqAgentTransport", "B": "NativeAgentTransportImpl"}:
            raise AssertionError(f"agent transports {kinds}")
        # version -> monotonic time of the transport's delivery and of the
        # install, per agent.
        delivered = {"A": {}, "B": {}}
        installs = {"A": {}, "B": {}}

        def watch(name, agent):
            original = agent.host.swap_from_wire
            deliver = agent.transport.on_model

            def swap(version, blob):
                out = original(version, blob)
                if out is not None:
                    installs[name].setdefault(int(version), time.monotonic())
                return out

            def tap(version, blob):
                delivered[name].setdefault(int(version), time.monotonic())
                deliver(version, blob)

            agent.host.swap_from_wire = swap
            agent.transport.on_model = tap

        for name, agent in agents.items():
            watch(name, agent)
        payloads = []  # B's wire payloads, for the decode timing
        send = agents["B"].transport.send_trajectory

        def capture(payload, agent_id=None):
            if len(payloads) < 16:
                payloads.append(bytes(payload))
            return send(payload, agent_id=agent_id)

        agents["B"].transport.send_trajectory = capture
        venvs = {name: SyncVectorEnv([lambda: RecallEnv(LEARNER_HORIZON, N_CUES)]
                                     * agent.num_envs)
                 for name, agent in agents.items()}
        waves = {"A": 0, "B": 0}

        def wave(name):
            run_vector_gym_loop(agents[name], venvs[name], LEARNER_HORIZON,
                                seed=SEED + 1000 * (name == "B") + waves[name])
            waves[name] += 1

        def lanes():
            return {lane: n for agent in agents.values()
                    for lane, n in agent.spool.sent_counts().items()}

        # Train: FLEET_WAVES waves of both agents.
        zero_flash_counts()  # after each agent's validation forward
        d0 = {n: a.host.dispatches for n, a in agents.items()}
        t0 = time.perf_counter()
        for _ in range(FLEET_WAVES):
            wave("A")
            wave("B")
        wall = time.perf_counter() - t0
        trained = FLEET_WAVES * (DIST_LANES + FLEET_LANES_B) // per_epoch
        status = server.wait(
            lambda s: (s["version"] == trained
                       and (s.get("published") or {}).get("version") == trained
                       and agents["A"].model_version == trained
                       and agents["B"].model_version == trained),
            f"{trained} updates published and installed by A and B",
            timeout_s=FLEET_TIMEOUT_S)
        digests = {}
        for name, agent in agents.items():
            with agent.host._lock:
                digests[name] = (agent.host.version,
                                 tree_digest(params_to_jax(agent.host.params)))
        published = status["published"]
        for name, got in digests.items():
            if got != (published["version"], published["digest"]):
                raise AssertionError(f"agent {name} holds {got}, published "
                                     f"{published}")
        hop_ms = {kind: [1e3 * (times["A"][v] - times["B"][v])
                         for v in sorted(times["B"]) if v in times["A"]]
                  for kind, times in (("delivery", delivered), ("install", installs))}

        # The relay SIGKILL drill: a wave of A's takes the server mid-epoch,
        # the relay dies, A plays a wave into the outage, the replacement
        # relay restarts on the same spool.
        wave("A")
        relay.kill()
        v_kill = max(server.status()["version"], agents["A"].model_version)
        wave("A")
        relay = RelayProcess(root, relay_cfg, workdir, "replacement")
        wave("A")
        wave("B")

        def heal():
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline:
                s = server.status()
                if s and s["version"] > v_kill and agents["A"].model_version > v_kill:
                    return
                time.sleep(0.2)
            wave("A")

        server.wait(lambda s: (s["version"] > v_kill
                               and agents["A"].model_version > v_kill),
                    "training past the relay kill, installed by A",
                    timeout_s=FLEET_TIMEOUT_S, poll=heal)
        # A resync from A, held below the relay's cached keyframe.
        agents["A"].transport.request_resync(0)
        for agent in agents.values():
            if not agent.spool.flush(deadline_s=60):
                raise AssertionError("an agent's spool never flushed")
        time.sleep(1.0)
        relay_result = relay.close()
        relay = None
        sent = lanes()

        def reconciled(s):
            rows = s["accounting"]["agents"]
            return all(rows.get(lane, {}).get("max_seq") == n
                       and rows[lane]["contiguous"] for lane, n in sent.items())

        status = server.wait(reconciled, "every leaf sequence accounted",
                             timeout_s=FLEET_TIMEOUT_S)
        dispatches = {n: a.host.dispatches - d0[n] for n, a in agents.items()}
        agent_counts = flash_counts()
        a_version = agents["A"].model_version
    finally:
        for agent in agents.values():
            agent.disable_agent()
        if relay is not None:
            relay.kill()
        server.stop()

    # Gates.
    stats = status["stats"]
    if stats["learner_errors"] or stats["dropped"] or stats["publish_errors"]:
        raise AssertionError(f"server stats {stats}: {status['last_learner_error']}")
    check_clean_guardrails(status)
    for lane, n in sent.items():
        row = status["accounting"]["agents"].get(lane)
        if row != {"max_seq": n, "accepted": n, "contiguous": True}:
            raise AssertionError(f"ingest accounting of {lane}: {row}, sent {n}")
    total = sum(sent.values())
    if stats["trajectories"] != total:
        raise AssertionError(f"trained {stats['trajectories']} trajectories, "
                             f"sent {total} (zero loss, zero double-train)")
    decoded = status["decoded_by"]
    if decoded != {"native": total, "python": 0, "columnar": 0}:
        raise AssertionError(f"decoders {decoded}; {total} trajectories ingested")
    updates = stats["updates"]
    kernels = status["kernels"]
    server_counts = (kernels["flash_fwd"], kernels["flash_dq"], kernels["flash_dkv"])
    if server_counts != tuple(updates * c for c in per_update):
        raise AssertionError(f"server launches {server_counts} over {updates} "
                             f"updates; expected {updates} x {per_update}")
    n_dispatch = sum(dispatches.values())
    if agent_counts != ((n_layers - 1) * n_dispatch, 0, 0):
        raise AssertionError(f"agent launches {agent_counts} over {n_dispatch} "
                             f"dispatches")
    if first_counts != per_update:
        # compare_update's kernel side (the plain side launches nothing).
        raise AssertionError(f"first update launches {first_counts}")
    if not a_version > v_kill:
        raise AssertionError(f"agent A at version {a_version}, relay killed at {v_kill}")
    relay_stats = relay_result["stats"]
    if not (relay_stats["resyncs_served"] >= 1
            and relay_stats["trajectory_frames_forwarded"] > 0):
        raise AssertionError(f"replacement relay stats {relay_stats}")
    rows = _progress_rows(server_dir)
    if len(rows) != updates or not all(
            math.isfinite(float(r[k])) for r in rows for k in ("RhoMean", "KL")):
        raise AssertionError(f"{len(rows)} epoch log rows for {updates} updates: "
                             f"{[(r.get('RhoMean'), r.get('KL')) for r in rows]}")

    # Measurements.
    decoder = NativeDecoder()
    if not all(isinstance(decoder.decode(p), DecodedTrajectory) for p in payloads):
        raise AssertionError("the native codec fell back on B's payloads")
    native_ms = statistics.mean(host_ms(lambda p=p: decoder.decode(p), 20)
                                for p in payloads)
    python_ms = statistics.mean(host_ms(lambda p=p: deserialize_actions(p), 5)
                                for p in payloads)
    profile = json.loads(Path(cfg["profile"]["path"]).read_text())
    return {"plain": plain, "cpu": cpu, "first_counts": first_counts,
            "on_actors": on_actors,
            "update_ms": update_ms, "updates": updates,
            "server_counts": server_counts, "per_update": per_update,
            "agent_counts": agent_counts, "dispatches": dispatches,
            "wall": wall, "trajectories": total, "decoded": decoded,
            "digests": digests, "v_kill": v_kill, "a_version": a_version,
            "relay": relay_stats,
            "duplicates": status["accounting"]["duplicates"],
            "rho_mean": [float(r["RhoMean"]) for r in rows],
            "native_ms": native_ms, "python_ms": python_ms,
            "payload_bytes": statistics.mean(len(p) for p in payloads),
            "hop_ms": hop_ms, "profile": profile}


def ppo_learner(device, workdir: Path, learned: dict) -> dict:
    """Phase 14: PPO at the flagship arch in this process. Its first update
    on phase 5's first batch through the kernels against the plain
    attention (phase 5's bars) and, at f32, against the CPU on the same
    index sets; then PPO_UPDATES updates on phase 5's first wave with the
    launches of each counted (16 minibatches x n_layers of K1, K2 and K3:
    nothing outside the minibatch loop evaluates); the KL stop (a
    ``target_kl`` of -1 trips it after the first minibatch: ``StopIter``
    1 on the card and on the CPU, and the pi params and pi Adam state after
    the update bit-equal to those after the first minibatch alone); and
    the learning checks of tests/test_ppo.py (CartPole) and
    tests/test_impala.py (stale behavior) on the card."""
    import shutil

    import numpy as np
    import torch

    from relayrl_tpu_torch.algorithms import build_algorithm
    from relayrl_tpu_torch.algorithms.onpolicy import read_metrics
    from relayrl_tpu_torch.algorithms.ppo import draw_minibatches
    from relayrl_tpu_torch.envs import make
    from relayrl_tpu_torch.ops.flash import flash_attention_plain
    from relayrl_tpu_torch.runtime.local_runner import LocalRunner
    from relayrl_tpu_torch.types import ActionRecord

    shutil.rmtree(workdir, ignore_errors=True)
    batch = learned["batch"]
    rows = int(batch["obs"].shape[0])
    algo = build_learner(device, workdir / "learner", algorithm="PPO", hp=PPO_HP)
    idx, _ = draw_minibatches(algo.state.rng, rows, algo.train_iters,
                              algo.minibatch_count)
    if tuple(idx.shape) != (PPO_UPDATE_MINIBATCHES, PPO_MINIBATCH_ROWS):
        raise AssertionError(f"index sets {tuple(idx.shape)}")
    params0 = copy.deepcopy(algo.state.params)
    zero_flash_counts()
    plain = compare_update(algo, params0, batch, device,
                           lambda q, k, v: flash_attention_plain(q, k, v, True)[0],
                           idx_sets=idx)
    first_counts = flash_counts()
    n_layers = SLICE_ARCH["n_layers"]
    per_update = (PPO_UPDATE_MINIBATCHES * n_layers,) * 3
    if first_counts != per_update:
        raise AssertionError(f"first update launches {first_counts}, expected {per_update}")

    # The KL stop on the card: the whole update against its first minibatch.
    def stop_run(index_sets):
        params = copy.deepcopy(params0)
        state = algo.fresh_state(params)
        update = algo.make_update(algo.policy, target_kl=-1.0)
        state, metrics = update(state, {k: torch.as_tensor(v, device=device)
                                        for k, v in batch.items()}, index_sets)
        pi = {n: p.detach().clone() for n, p in state.params.named_parameters()
              if not n.startswith("vf")}
        adam = [(float(st["step"]), st["exp_avg"].clone(), st["exp_avg_sq"].clone())
                for st in (state.pi_opt.state[p] for p in
                           state.pi_opt.param_groups[0]["params"])]
        return pi, adam, read_metrics(metrics)

    full_pi, full_adam, full_m = stop_run(idx)
    one_pi, one_adam, _ = stop_run(idx[:1])
    if full_m["StopIter"] != 1.0:
        raise AssertionError(f"StopIter {full_m['StopIter']} on the card")
    for name, p in full_pi.items():
        if not torch.equal(p, one_pi[name]):
            raise AssertionError(f"pi param {name} moved after the KL stop")
    for (s1, m1, v1), (s2, m2, v2) in zip(full_adam, one_adam):
        if not (s1 == s2 == 1.0 and torch.equal(m1, m2) and torch.equal(v1, v2)):
            raise AssertionError(f"pi Adam state moved after the KL stop: steps {s1}, {s2}")

    # The same update on the CPU, at f32, on the same index sets, with and
    # without the stop.
    f32 = build_learner(device, workdir / "learner_f32",
                        arch={**SLICE_ARCH, "precision": "float32"},
                        algorithm="PPO", hp=PPO_HP)
    cpu = compare_update_to_cpu(f32, copy.deepcopy(f32.state.params), batch, idx)
    cpu_stop = compare_update_to_cpu(f32, copy.deepcopy(f32.state.params), batch,
                                     idx, target_kl=-1.0)
    if cpu_stop["metrics"]["StopIter"] != 1.0:
        raise AssertionError(f"StopIter {cpu_stop['metrics']['StopIter']} at f32")
    del f32

    # PPO_UPDATES updates on phase 5's first wave, launches per update.
    per, seconds = [], []
    for records in learned["first_wave"]:
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
        per.append(counts)
        seconds.append(elapsed)
    if len(per) != PPO_UPDATES or any(c != per_update for c in per):
        raise AssertionError(f"launches per update {per}; expected {PPO_UPDATES} "
                             f"x {per_update}")
    metrics = read_metrics(algo._last_metrics)
    if algo.version != PPO_UPDATES or not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"PPO at version {algo.version}: {metrics}")
    profile_device(lambda: algo.train_on_batch(batch), 1, "update")
    del algo

    # Learning, on the card: tests/test_ppo.py's CartPole check.
    runner = LocalRunner(make("CartPole-v1"), "PPO", env_dir=str(workdir / "cartpole"),
                         seed=0, device=device, **PPO_CARTPOLE_HP)
    cart = runner.train(epochs=PPO_CARTPOLE_EPOCHS, max_steps=200)
    if not cart["avg_return_last_window"] > PPO_CARTPOLE_BAR:
        raise AssertionError(f"PPO CartPole: {cart}")

    # tests/test_impala.py's stale-behavior check.
    impala = build_algorithm(
        "IMPALA", obs_dim=4, act_dim=2, traj_per_epoch=4, hidden_sizes=[32],
        lr=1e-2, ent_coef=0.0, env_dir=str(workdir / "stale"), device=device)
    ratio_means = []
    for s in range(STALE_EPISODES):
        rng = np.random.default_rng(s)
        recs = []
        for i in range(12):
            act = int(rng.random() < 0.3)
            recs.append(ActionRecord(
                obs=rng.standard_normal(4).astype(np.float32), act=np.int64(act),
                rew=1.0 if act == 1 else 0.0,
                data={"logp_a": np.float32(np.log(0.3 if act == 1 else 0.7)),
                      "v": np.float32(0.0)},
                done=(i == 11)))
        if impala.receive_trajectory(recs):
            ratio_means.append(read_metrics(impala._last_metrics)["RhoMean"])
    obs = np.random.default_rng(5).standard_normal((16, 4)).astype(np.float32)
    with torch.no_grad():
        logp, _, _ = impala.policy.evaluate(
            impala.state.params, torch.as_tensor(obs, device=device),
            torch.ones(16, dtype=torch.int64, device=device))
    p_one = float(torch.exp(logp).mean())
    if not p_one > STALE_BAR or not all(0.0 < r <= 1.0 + 1e-6 for r in ratio_means):
        raise AssertionError(f"IMPALA stale behavior: P(action 1) {p_one}, "
                             f"RhoMean {ratio_means}")
    return {"plain": plain, "cpu": cpu, "cpu_stop": cpu_stop, "per_update": per_update,
            "launches": tuple(sum(c[i] for c in per) for i in range(3)),
            "updates": len(per), "seconds": seconds, "metrics": metrics,
            "stop_metrics": full_m, "cartpole": cart, "p_one": p_one,
            "stale_updates": len(ratio_means)}


def golden_offpolicy(root: Path, name: str) -> tuple[dict, int, int, str]:
    """An off-policy golden's hyperparameters (its ``config.json``, the
    EpochLogger dump), its widths and its env."""
    cfg = json.loads((root / "examples" / "golden" / OFFPOLICY_GOLDENS[name]
                      / "config.json").read_text())
    hp = {k: v for k, v in cfg.items()
          if k not in ("algorithm", "exp_name", "obs_dim", "act_dim")}
    env_id = "CartPole-v1" if cfg["discrete"] else "Pendulum-v1"
    return hp, int(cfg["obs_dim"]), int(cfg["act_dim"]), env_id


def build_offpolicy(device, root: Path, name: str, workdir: Path, **overrides):
    """The port's ``name`` learner at its golden's hyperparameters (f32,
    ``seed_salt`` 0), and its env id."""
    from relayrl_tpu_torch.algorithms import build_algorithm

    hp, obs_dim, act_dim, env_id = golden_offpolicy(root, name)
    algo = build_algorithm(name, obs_dim=obs_dim, act_dim=act_dim,
                           env_dir=str(workdir), config_path=_local_config(workdir),
                           device=device, logger_kwargs={"output_dir": str(workdir / "logs")},
                           **{**hp, "seed_salt": 0, **overrides})
    return algo, env_id


def random_episodes(env, steps: int, seed: int) -> list:
    """Episodes of a seeded uniform-random behavior on ``env`` (an env or a
    built-in env id) until ``steps`` steps, as ``PolicyActor`` ships them:
    one record per step with the reward the action earned (the observation
    as ``normalize_obs`` puts it on the wire: byte frames stay uint8), then
    the terminal marker (the successor observation on a time-limit
    ending)."""
    import numpy as np

    from relayrl_tpu_torch.envs import make
    from relayrl_tpu_torch.runtime.policy_actor import normalize_obs
    from relayrl_tpu_torch.types.action import ActionRecord

    env = make(env) if isinstance(env, str) else env
    rng = np.random.default_rng(seed)
    discrete = hasattr(env.action_space, "n")
    episodes, total = [], 0
    while total < steps:
        obs, _ = env.reset(seed=int(rng.integers(2 ** 31)))
        records = []
        while True:
            act = (np.int32(rng.integers(env.action_space.n)) if discrete
                   else rng.uniform(-2.0, 2.0, 1).astype(np.float32))
            nxt, rew, term, trunc, _ = env.step(int(act) if discrete else act)
            records.append(ActionRecord(obs=normalize_obs(obs), act=act, rew=float(rew)))
            obs = nxt
            if term or trunc:
                records.append(ActionRecord(
                    obs=None if term else normalize_obs(obs), rew=0.0,
                    done=True, truncated=not term))
                break
        episodes.append(records)
        total += len(records) - 1
    return episodes


def _to(value, device):
    """A batch, a noise tensor or a tuple of them, moved to ``device``."""
    import torch

    if value is None:
        return None
    if isinstance(value, tuple):
        return tuple(_to(v, device) for v in value)
    if isinstance(value, dict):
        return {k: torch.as_tensor(v).to(device) for k, v in value.items()}
    return value.to(device)


def compare_offpolicy_to_cpu(algo, trees: dict, batch: dict, noise) -> dict:
    """One update of ``algo``'s family from the networks ``trees`` (fresh
    Adam) on ``batch`` with the injected ``noise``, on the card and on the
    CPU: ``compare_update_to_cpu``'s bars (metrics within
    ``MLP_METRIC_RTOL`` plus ``MLP_METRIC_ATOL``; every parameter element
    within ``MLP_PARAM_ATOL``, except where the CPU side's RMS gradient fell
    below ``ADAM_FLOOR``: there Adam's step bound, the learning rate per
    step; a target network's element takes its online element's rule)."""
    import dataclasses

    import torch

    from relayrl_tpu_torch.algorithms.onpolicy import read_metrics

    least_rms = {}

    def track_rms(opt, args, kwargs):
        beta2 = opt.param_groups[0]["betas"][1]
        for p, st in opt.state.items():
            rms = st["exp_avg_sq"].sqrt() / math.sqrt(1 - beta2 ** float(st["step"]))
            least_rms[p] = torch.minimum(least_rms[p], rms) if p in least_rms else rms

    sides = {}
    for side, dev in (("card", algo.device), ("cpu", torch.device("cpu"))):
        modules = {f: algo.load_module(f, tree, dev) for f, tree in trees.items()}
        state = algo.fresh_state(modules, rng=getattr(algo.state, "rng", None))
        opts = [o for o in vars(state).values() if isinstance(o, torch.optim.Optimizer)]
        if side == "cpu":
            for opt in opts:
                opt.register_step_post_hook(track_rms)
        state, metrics = algo._update(state, _to(batch, dev), _to(noise, dev))
        sides[side] = (state, read_metrics(metrics), opts)
    (card, got_m, _), (cpu, want_m, opts) = sides["card"], sides["cpu"]
    metric_err = param_err = floor_err = 0.0
    n_floored = 0
    for key, value in want_m.items():
        err = abs(got_m[key] - value)
        if not err <= MLP_METRIC_RTOL * abs(value) + MLP_METRIC_ATOL:
            raise AssertionError(f"{algo.ALGO_NAME} metric {key}: card {got_m[key]} "
                                 f"vs cpu {value}")
        metric_err = max(metric_err, err)
    bound_of = {p: o.param_groups[0]["lr"] * float(o.state[p]["step"])
                for o in opts for p in o.param_groups[0]["params"]}
    for field in dataclasses.fields(cpu):
        module = getattr(cpu, field.name)
        if not isinstance(module, torch.nn.Module):
            continue
        online = dict(getattr(cpu, field.name.removeprefix("target_")).named_parameters())
        on_card = dict(getattr(card, field.name).named_parameters())
        for name, p in module.named_parameters():
            diff = (on_card[name].detach().cpu() - p.detach()).abs()
            noise_el = least_rms[online[name]] < ADAM_FLOOR
            bound = torch.where(noise_el, bound_of[online[name]], MLP_PARAM_ATOL)
            if not bool((diff <= bound).all()):
                i = int((diff - bound).argmax())
                raise AssertionError(
                    f"{algo.ALGO_NAME} {field.name}.{name}: card vs cpu "
                    f"{diff.flatten()[i].item()} above {bound.flatten()[i].item()}")
            param_err = max(param_err, diff.where(~noise_el, 0.0).max().item())
            floor_err = max(floor_err, diff.where(noise_el, 0.0).max().item())
            n_floored += int(noise_el.sum())
    return {"metric_err": metric_err, "param_err": param_err, "n_floored": n_floored,
            "floor_err": floor_err, "metrics": got_m}


def offpolicy_learners(device, root: Path, workdir: Path) -> dict:
    """Phase 15a-b: each off-policy algorithm at its golden's config on the
    card. Its ring filled past ``update_after`` with random-behavior
    episodes; ``OFFPOLICY_WARM`` updates from its initial params (so the
    targets differ from the online networks), then one update from there on
    the card against the same update on the CPU, on the same sampled batch
    with the same noise (:func:`compare_offpolicy_to_cpu`); the ms per
    gradient update over ``OFFPOLICY_TIMED`` updates (synchronized, the
    staged batch's host-to-device copy included) and the device's busy share
    over 10 more (``profile_device``); and ``updates_per_dispatch``
    4 against 4 single updates from the same seed on the same batches,
    bit-equal, in one dispatch against four."""
    import shutil

    import torch

    from relayrl_tpu_torch.types.model_bundle import leaf_manifest
    from relayrl_tpu_torch.weights import tree_digest

    shutil.rmtree(workdir, ignore_errors=True)
    out = {}
    for i, name in enumerate(OFFPOLICY_GOLDENS):
        algo, env_id = build_offpolicy(device, root, name, workdir / name)
        for ep in random_episodes(env_id, algo.update_after + algo.batch_size, SEED + i):
            algo.buffer.add_episode(ep)
        for _ in range(OFFPOLICY_WARM):
            algo.train_on_batch(algo.buffer.sample(algo.batch_size))
        trees = algo.state_trees()
        batch = algo.buffer.sample(algo.batch_size)
        noise, _ = algo._draw_noise(algo.state)
        cmp = compare_offpolicy_to_cpu(algo, trees, batch, noise)

        staged = algo._sample_staged(1)
        for _ in range(3):
            algo.train_on_batch(staged)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(OFFPOLICY_TIMED):
            algo.train_on_batch(staged)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / OFFPOLICY_TIMED
        print(f"[offpolicy] {name}:", flush=True)
        prof = profile_device(lambda: algo.train_on_batch(staged), 10, "gradient update")

        loop, _ = build_offpolicy(device, root, name, workdir / f"{name}_loop")
        fused, _ = build_offpolicy(device, root, name, workdir / f"{name}_fused",
                                   updates_per_dispatch=OFFPOLICY_FUSED)
        batches = [algo.buffer.sample(algo.batch_size) for _ in range(OFFPOLICY_FUSED)]
        for b in batches:
            loop.train_on_batch(b)
        before = fused.inflight.dispatch_count
        fused.train_on_batches(batches)
        torch.cuda.synchronize()
        if (fused.inflight.dispatch_count - before != 1
                or (loop.version, fused.version) != (OFFPOLICY_FUSED, OFFPOLICY_FUSED)):
            raise AssertionError(f"{name} fused: {fused.inflight.dispatch_count - before} "
                                 f"dispatches, versions {loop.version}/{fused.version}")
        a, b = loop.state_trees(), fused.state_trees()
        for field in a:
            if tree_digest(a[field]) != tree_digest(b[field]):
                raise AssertionError(f"{name} fused vs unfused: {field} differs")
        tensors = sum(len(leaf_manifest(tree)[1]) for tree in a.values())
        if dict(loop._last_metrics) != dict(fused._last_metrics):
            raise AssertionError(f"{name} fused metrics {dict(fused._last_metrics)} != "
                                 f"{dict(loop._last_metrics)}")
        out[name] = {**cmp, "ms": ms, "profile": prof, "fused_tensors": tensors,
                     "env": env_id,
                     "batch": algo.batch_size, "hidden": algo.arch["hidden_sizes"],
                     "ring": algo.buffer.capacity}
    return out


def offpolicy_local(device, root: Path, workdir: Path) -> dict:
    """Phase 15c: ``LocalRunner`` on CartPole-v1 (DQN) and Pendulum-v1
    (SAC) at the goldens' hyperparameters for ``OFFPOLICY_LOCAL`` updates
    past ``update_after`` (an update is an episode that trained). Gates
    what a short run shows: finite returns, the learner's version and the
    actor's advancing together at every hot swap, DQN's epsilon annealed
    into every bundle (falling, below its start, equal to the learner's
    schedule), no flash or ring kernel. Returns the env steps/s and the
    gradient updates."""
    import shutil

    import torch

    from relayrl_tpu_torch.envs import make
    from relayrl_tpu_torch.runtime import LocalRunner

    shutil.rmtree(workdir, ignore_errors=True)
    out = {}
    for name, updates in OFFPOLICY_LOCAL.items():
        hp, _, _, env_id = golden_offpolicy(root, name)
        seed = hp.pop("seed")  # seeds the learner and the actor alike
        runner = LocalRunner(make(env_id), name, config_path=_local_config(workdir / name),
                             env_dir=str(workdir / name), seed=seed, device=device,
                             **{**hp, "seed_salt": 0})
        algo, actor = runner.algorithm, runner.actor
        swaps = []
        swap = actor.maybe_swap

        def spy(bundle, swap=swap, algo=algo):
            installed = swap(bundle)
            swaps.append((bundle.version, algo.version, bundle.arch.get("epsilon"),
                          installed))
            return installed

        actor.maybe_swap = spy
        t0 = time.perf_counter()
        result = runner.train(epochs=updates)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        versions = [v for v, _, _, _ in swaps]
        if (runner.updates != updates or len(swaps) != updates
                or not all(ok and v == a for v, a, _, ok in swaps)
                or versions != sorted(set(versions)) or versions[0] < 1
                or actor.version != algo.version
                or not all(math.isfinite(r) for r in result["returns"])):
            raise AssertionError(f"{name} LocalRunner: updates {runner.updates}, swaps "
                                 f"{swaps}, actor {actor.version}, learner {algo.version}")
        if name in ("DQN", "C51"):
            eps = [e for _, _, e, _ in swaps]
            if not (all(x > y for x, y in zip(eps, eps[1:])) and eps[-1] < hp["epsilon_start"]
                    and eps[-1] == algo.current_epsilon() == actor.arch["epsilon"]):
                raise AssertionError(f"{name} epsilon into the bundles: {eps}")
        out[name] = {"updates": runner.updates, "grad_updates": algo.version,
                     "steps": actor.steps_served, "wall": wall,
                     "avg_return": result["avg_return_last_window"],
                     "epsilon": actor.arch.get("epsilon")}
    return out


def settle_lanes(server, agent, what: str) -> dict:
    """Waits until ``server`` has ingested every trajectory the
    ``VectorAgent`` sent and the agent has installed the last publish,
    then checks the run: no learner error, drop or publish error, a clean
    guardrail book, every lane's accounting exact (accepted == max_seq ==
    sent, contiguous), the agent's params sha256-equal to the publish.
    Returns the status, the agent's version and params digest and the
    trajectories sent."""
    from relayrl_tpu_torch.weights import params_to_jax, tree_digest

    status = server.wait(
        lambda s: (s["stats"]["trajectories"] == sum(agent.spool.sent_counts().values())
                   and (s.get("published") or {}).get("version") == s["version"]
                   and agent.model_version == s["version"]),
        "every sent trajectory ingested and the last publish installed")
    sent = agent.spool.sent_counts()
    with agent.host._lock:
        version = agent.host.version
        digest = tree_digest(params_to_jax(agent.host.params))
    stats = status["stats"]
    if stats["learner_errors"] or stats["dropped"] or stats["publish_errors"]:
        raise AssertionError(f"{what} server stats {stats}: {status['last_learner_error']}")
    check_clean_guardrails(status)
    for lane in agent.agent_ids:
        row = status["accounting"]["agents"].get(lane)
        if row != {"max_seq": sent[lane], "accepted": sent[lane], "contiguous": True}:
            raise AssertionError(f"ingest accounting of {lane}: {row}, sent {sent[lane]}")
    published = status["published"]
    if (version, digest) != (published["version"], published["digest"]):
        raise AssertionError(f"agent params at version {version} ({digest}) != "
                             f"published {published}")
    return {"status": status, "version": version, "digest": digest,
            "trajectories": sum(sent.values())}


def offpolicy_server(device, root: Path, workdir: Path) -> dict:
    """Phase 15d: DQN at the cartpole_dqn golden's config in a
    ``chaos_server`` process over ZMQ (the default config, guardrails on),
    fed by a ``VectorAgent`` of ``OFFPOLICY_LANES`` CartPole lanes in this
    process for ``OFFPOLICY_SERVER_STEPS`` env steps (the golden's
    ``update_after`` and ~600 more), then until every sent trajectory is
    ingested and the last publish installed. Gates: at least
    ``OFFPOLICY_SERVER_INGESTS`` ingests that trained;
    exact ingest accounting; more gradient updates than ingests that
    trained (the list branch: each ingest trains every batch ``accumulate``
    returns); the agent's params at the last publish's version sha256-equal
    to it; no learner error and a clean guardrail book; no flash or ring
    kernel in either process."""
    import shutil

    import numpy as np

    from relayrl_tpu_torch.envs import SyncVectorEnv, make
    from relayrl_tpu_torch.runtime.agent import VectorAgent

    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    server_addrs, agent_addrs = zmq_addrs()
    hp, obs_dim, act_dim, env_id = golden_offpolicy(root, "DQN")
    cfg = {"algorithm": "DQN", "obs_dim": obs_dim, "act_dim": act_dim,
           "hyperparams": {**hp, "seed_salt": 0}, "device": str(device),
           "scratch": str(workdir / "server"), "digests": True,
           "status_path": str(workdir / "status.json"), **server_addrs}
    agent_config = workdir / "agent_config.json"
    agent_config.write_text(json.dumps({}))
    server = ChaosServer(root, cfg, workdir / "server.log")
    agent = None
    try:
        server.wait(lambda s: True, "the DQN server to come up")
        agent = VectorAgent(num_envs=OFFPOLICY_LANES, config_path=str(agent_config),
                            seed=SEED, probe=False, device=device,
                            model_path=str(workdir / "client_model.rlx"), **agent_addrs)
        venv = SyncVectorEnv([lambda: make(env_id)] * OFFPOLICY_LANES)
        obs, _ = venv.reset(seed=SEED)
        rewards = np.zeros(OFFPOLICY_LANES, np.float32)
        steps = 0

        def play(n):
            # One stream of episodes across calls (no reset between them).
            nonlocal obs, steps
            for _ in range(n):
                records = agent.request_for_actions(obs, rewards=rewards)
                obs, rews, terms, truncs, infos = venv.step(
                    [int(np.asarray(r.act).reshape(-1)[0]) for r in records])
                rewards[:] = rews
                for lane in range(OFFPOLICY_LANES):
                    if terms[lane] or truncs[lane]:
                        agent.flag_last_action(
                            lane, float(rews[lane]), truncated=not terms[lane],
                            final_obs=(infos[lane]["final_observation"]
                                       if not terms[lane] else None),
                            terminated=bool(terms[lane]))
                        rewards[lane] = 0.0
                steps += OFFPOLICY_LANES

        zero_flash_counts()
        zero_ring_counts()
        t0 = time.perf_counter()
        play(OFFPOLICY_SERVER_STEPS // OFFPOLICY_LANES)
        wall = time.perf_counter() - t0
        agent_counts = flash_counts() + ring_counts()
        run = settle_lanes(server, agent, "DQN")
        status, stats = run["status"], run["status"]["stats"]
        if not status["version"] > stats["updates"] >= OFFPOLICY_SERVER_INGESTS:
            raise AssertionError(f"{status['version']} gradient updates over "
                                 f"{stats['updates']} ingests that trained")
        kernels = status["kernels"]
        if any(kernels.values()) or any(agent_counts):
            raise AssertionError(f"flash/ring launches: server {kernels}, agent "
                                 f"{agent_counts}")
        return {"updates": stats["updates"], "grad_updates": status["version"],
                "trajectories": run["trajectories"], "steps": steps, "wall": wall,
                "digest": run["digest"], "epsilon": agent.host.arch["epsilon"],
                "timings": status["timings"], "kernels": kernels}
    finally:
        if agent is not None:
            agent.disable_agent()
        server.stop()


def pixel_learners(device, root: Path, workdir: Path) -> dict:
    """Phase 16a, in this process, at the Pong north star's shape: the
    Nature CNN on ``make_atari("synthetic")``'s 84x84x4 uint8 frames, f32.
    ``evaluate`` on the card against the CPU from the same params on the
    same frames (f32 bar); PPO's first update (its ``LocalRunner``'s first
    epoch) on the card against the CPU on the same index sets, and one
    pixel DQN update on a uint8 ring against the CPU on the same batch
    (phase 9's bars and Adam-floor rule); ms per evaluate and per update.
    The caller zeroes the flash and ring counts before and reads them
    after: no pixel path launches K1-K6."""
    import shutil

    import numpy as np
    import torch

    from relayrl_tpu_torch.algorithms import build_algorithm
    from relayrl_tpu_torch.algorithms.ppo import draw_minibatches
    from relayrl_tpu_torch.envs import make_atari
    from relayrl_tpu_torch.models import build_policy
    from relayrl_tpu_torch.runtime import LocalRunner
    from relayrl_tpu_torch.weights import params_to_jax

    shutil.rmtree(workdir, ignore_errors=True)
    env = make_atari("synthetic", obs_dtype="uint8")
    obs_shape = list(env.obs_shape)
    if obs_shape != [84, 84, 4]:
        raise AssertionError(f"make_atari's default frame {obs_shape}")
    arch = {"kind": "cnn_discrete", "obs_shape": obs_shape, "act_dim": 3}
    card, cpu = (build_policy(arch, d) for d in (device, torch.device("cpu")))
    tree = params_to_jax(card.init_params(torch.Generator().manual_seed(SEED)))
    frames = np.stack([r.obs for ep in random_episodes(env, PIXEL_FRAMES, SEED)
                       for r in ep if r.obs is not None][:PIXEL_FRAMES])
    act = np.random.default_rng(SEED).integers(0, 3, len(frames))
    outs = []
    for policy in (card, cpu):
        params = policy.load_params(tree)
        with torch.inference_mode():
            outs.append([x.cpu() for x in policy.evaluate(params, frames, act)])
    eval_err = max((a - b).abs().max().item() for a, b in zip(*outs))
    if not eval_err <= TOLERANCE["float32"]:
        raise AssertionError(f"CNN evaluate card vs cpu: {eval_err}")
    card_params = card.load_params(tree)
    frames_dev = torch.as_tensor(frames, device=device)
    with torch.inference_mode():
        eval_ms = time_ms(lambda: card.evaluate(card_params, frames_dev, act), iters=20)

    # PPO: the first epoch of a LocalRunner on the 84x84x4 frames.
    runner = LocalRunner(env, "PPO", config_path=_local_config(workdir / "ppo"),
                         env_dir=str(workdir / "ppo"), seed=SEED, device=device,
                         obs_shape=obs_shape, model_kind="cnn_discrete",
                         **PIXEL_PPO_HP)
    algo = runner.algorithm
    params0 = copy.deepcopy(algo.state.params)
    episodes = _spy_updates(runner, lambda actions, counts: None)
    t0 = time.perf_counter()
    runner.train(epochs=PIXEL_PPO_UPDATES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    batch = epoch_batches(algo, episodes, 1)[0]
    if batch["obs"].shape[-1] != 84 * 84 * 4 or runner.updates != PIXEL_PPO_UPDATES:
        raise AssertionError(f"pixel PPO batch {batch['obs'].shape}, updates "
                             f"{runner.updates}")
    idx, _ = draw_minibatches(algo.state.rng, int(batch["obs"].shape[0]),
                              algo.train_iters, algo.minibatch_count)
    ppo = compare_update_to_cpu(algo, params0, batch, idx_sets=idx)

    # DQN on a uint8 ring: the golden's config with the pixel trunk.
    hp, _, _, _ = golden_offpolicy(root, "DQN")
    dqn = build_algorithm(
        "DQN", obs_dim=84 * 84 * 4, act_dim=3, env_dir=str(workdir / "dqn"),
        config_path=_local_config(workdir / "dqn"), device=device,
        logger_kwargs={"output_dir": str(workdir / "dqn" / "logs")},
        **{**hp, "seed_salt": 0, "obs_shape": obs_shape, **PIXEL_DQN_HP})
    if dqn.buffer.obs.dtype != np.uint8:
        raise AssertionError(f"pixel DQN ring of {dqn.buffer.obs.dtype}")
    for ep in random_episodes(env, dqn.update_after + dqn.batch_size, SEED + 1):
        dqn.buffer.add_episode(ep)
    for _ in range(OFFPOLICY_WARM):
        dqn.train_on_batch(dqn.buffer.sample(dqn.batch_size))
    dqn_batch = dqn.buffer.sample(dqn.batch_size)
    if dqn_batch["obs"].dtype != np.uint8:
        raise AssertionError(f"pixel DQN batch of {dqn_batch['obs'].dtype}")
    dqn_cmp = compare_offpolicy_to_cpu(dqn, dqn.state_trees(), dqn_batch, None)
    staged = dqn._sample_staged(1)
    dqn_ms = _update_ms(lambda: dqn.train_on_batch(staged))
    ppo_ms = _update_ms(lambda: algo.train_on_batch(batch))
    return {"eval_err": eval_err, "eval_ms": eval_ms, "frames": len(frames),
            "ppo": ppo, "ppo_rows": tuple(batch["obs"].shape[:2]), "ppo_ms": ppo_ms,
            "ppo_steps": runner.actor.steps_served, "ppo_wall": wall,
            "dqn": dqn_cmp, "dqn_ms": dqn_ms, "dqn_batch": dqn.batch_size,
            "dqn_ring": dqn.buffer.capacity,
            "ring_bytes": dqn.buffer.obs.nbytes + dqn.buffer.obs2.nbytes}


def _update_ms(fn, iters: int = 5) -> float:
    """ms per call of a learner update ``fn`` (one warm call first; the
    calls end in a device sync)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def pixel_golden_local(device, root: Path, workdir: Path) -> dict:
    """Phase 16a: ``LocalRunner`` PPO at the ``pixel_ppo_catch`` golden's
    ``config.json`` (uncut: 36x36x2 frames, Nature trunk, 8 episodes per
    epoch) on the golden's env (the README's command: frame skip 2, raw
    board 48, shaped) for ``PIXEL_GOLDEN_UPDATES`` updates: versions
    advance with every hot swap, returns finite; env steps/s and ms per
    update."""
    import shutil

    import torch

    from relayrl_tpu_torch.envs import make_atari
    from relayrl_tpu_torch.runtime import LocalRunner

    shutil.rmtree(workdir, ignore_errors=True)
    cfg = json.loads((root / "examples" / "golden" / "pixel_ppo_catch"
                      / "config.json").read_text())
    hp = {k: v for k, v in cfg.items()
          if k not in ("algorithm", "exp_name", "obs_dim", "act_dim", "discrete")}
    env = make_atari("synthetic", **PIXEL_GOLDEN_ENV)
    if list(env.obs_shape) != cfg["obs_shape"]:
        raise AssertionError(f"golden env frame {env.obs_shape} vs {cfg['obs_shape']}")
    runner = LocalRunner(env, cfg["algorithm"], config_path=_local_config(workdir),
                         env_dir=str(workdir), device=device, **hp)
    algo = runner.algorithm
    marks = []
    episodes = _spy_updates(runner, lambda actions, counts: marks.append(algo.version))
    t0 = time.perf_counter()
    result = runner.train(epochs=PIXEL_GOLDEN_UPDATES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if (runner.updates != PIXEL_GOLDEN_UPDATES or algo.arch["kind"] != "cnn_discrete"
            or marks != list(range(1, PIXEL_GOLDEN_UPDATES + 1))
            or runner.actor.version != PIXEL_GOLDEN_UPDATES
            or not all(math.isfinite(r) for r in result["returns"])):
        raise AssertionError(f"pixel golden loop: updates {runner.updates}, versions "
                             f"{marks}, actor {runner.actor.version}")
    batch = epoch_batches(algo, episodes, 1)[0]
    return {"updates": runner.updates, "steps": runner.actor.steps_served, "wall": wall,
            "avg_return": result["avg_return_last_window"],
            "rows": tuple(batch["obs"].shape[:2]),
            "update_ms": _update_ms(lambda: algo.train_on_batch(batch))}


def pixel_server(device, root: Path, workdir: Path) -> dict:
    """Phase 16a: the ``ppo_pixel36_zmq`` matrix cell's config
    (``examples/run_matrix.py``: PPO, ``cnn_discrete`` on 36x36x2 frames,
    ``pi_lr`` 1e-3, 4 episodes per epoch) in a ``chaos_server`` process
    over ZMQ (default config, guardrails on), fed by a ``VectorAgent`` of
    ``PIXEL_LANES`` lanes of the cell's env in this process with uint8
    frames, until ``PIXEL_SERVER_UPDATES`` updates. Gates: the frames cross
    the wire as uint8; exact ingest accounting; the agent's params at the
    last publish sha256-equal to it; no learner error, a clean guardrail
    book; no flash or ring kernel in either process."""
    import shutil

    import numpy as np

    from relayrl_tpu_torch.envs import SyncVectorEnv, make_atari
    from relayrl_tpu_torch.runtime.agent import VectorAgent
    from relayrl_tpu_torch.types import deserialize_actions

    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    server_addrs, agent_addrs = zmq_addrs()
    def make_env():
        return make_atari("synthetic", obs_dtype="uint8", **PIXEL_GOLDEN_ENV)

    shape = make_env().obs_shape
    cfg = {"algorithm": "PPO", "obs_dim": int(np.prod(shape)), "act_dim": 3,
           "hyperparams": {**PIXEL_MATRIX_HP, "seed_salt": 0}, "device": str(device),
           "scratch": str(workdir / "server"), "digests": True,
           "status_path": str(workdir / "status.json"), **server_addrs}
    agent_config = workdir / "agent_config.json"
    agent_config.write_text(json.dumps({}))
    server = ChaosServer(root, cfg, workdir / "server.log")
    agent = None
    try:
        server.wait(lambda s: True, "the pixel PPO server to come up")
        agent = VectorAgent(num_envs=PIXEL_LANES, config_path=str(agent_config),
                            seed=SEED, probe=False, device=device,
                            model_path=str(workdir / "client_model.rlx"), **agent_addrs)
        payloads = []
        send = agent.spool.send
        agent.spool.send = lambda payload, *a, **k: (payloads.append(payload),
                                                     send(payload, *a, **k))[1]
        venv = SyncVectorEnv([make_env] * PIXEL_LANES)
        obs, _ = venv.reset(seed=SEED)
        rewards = np.zeros(PIXEL_LANES, np.float32)
        steps = 0

        def play():
            nonlocal obs, steps
            records = agent.request_for_actions(obs, rewards=rewards)
            obs, rews, terms, truncs, _ = venv.step(
                [int(np.asarray(r.act).reshape(-1)[0]) for r in records])
            rewards[:] = rews
            for lane in range(PIXEL_LANES):
                if terms[lane] or truncs[lane]:
                    agent.flag_last_action(lane, float(rews[lane]),
                                           truncated=not terms[lane],
                                           terminated=bool(terms[lane]))
                    rewards[lane] = 0.0
            steps += PIXEL_LANES

        zero_flash_counts()
        zero_ring_counts()
        t0 = time.perf_counter()
        status = server.wait(lambda s: s["stats"]["updates"] >= PIXEL_SERVER_UPDATES,
                             f"{PIXEL_SERVER_UPDATES} pixel PPO updates", poll=play)
        wall = time.perf_counter() - t0
        agent_counts = flash_counts() + ring_counts()
        run = settle_lanes(server, agent, "pixel PPO")
        status = run["status"]
        frames = [r.obs for p in payloads for r in deserialize_actions(p) if r.obs is not None]
        if not frames or any(np.asarray(f).dtype != np.uint8 for f in frames):
            raise AssertionError(f"wire frames: {len(frames)}, dtypes "
                                 f"{sorted({str(np.asarray(f).dtype) for f in frames})}")
        kernels = status["kernels"]
        if any(kernels.values()) or any(agent_counts):
            raise AssertionError(f"flash/ring launches: server {kernels}, agent "
                                 f"{agent_counts}")
        return {"updates": status["stats"]["updates"], "trajectories": run["trajectories"],
                "steps": steps, "wall": wall, "digest": run["digest"],
                "version": run["version"], "frames": len(frames),
                "payload_bytes": sum(map(len, payloads)) / len(payloads),
                "timings": status["timings"], "kernels": kernels}
    finally:
        if agent is not None:
            agent.disable_agent()
        server.stop()


@contextlib.contextmanager
def pinned_routes(log: list, changes: dict):
    """Pins the MoE's routes across two runs of the same computation. A
    top-k router is discontinuous: where two gates of a token nearly tie,
    bf16 rounding that differs between two attentions picks other experts
    (and every later position of the lane attends the changed token), so
    no bar on a smooth function holds across such a change. While ``log``
    is empty, every MoE layer's top-k indices are recorded in call order;
    otherwise they are replayed in that order (each token's top-k gate
    values gathered at the recorded experts), and ``changes`` counts the
    tokens whose own top-k would have differed (``"changed"`` of
    ``"tokens"``). The first run of a comparison (the kernels) records, the
    second (the plain attention) replays."""
    from relayrl_tpu_torch.models import moe

    own_top_k = moe.top_k_stable
    replay = iter(list(log)) if log else None

    def top_k(values, k):
        vals, idx = own_top_k(values, k)
        if replay is None:
            log.append(idx)
            return vals, idx
        pinned = next(replay)
        changes["changed"] += int((idx.sort(-1)[0] != pinned.sort(-1)[0]).any(-1).sum())
        changes["tokens"] += idx.shape[0]
        return values.gather(-1, pinned), pinned

    moe.top_k_stable = top_k
    try:
        yield
    finally:
        moe.top_k_stable = own_top_k


def route_pinning():
    """A ``wrap`` for :func:`update_sides` and :func:`compare_evaluate`
    that pins the MoE's routes of the second side (the plain attention) to
    the first's (the kernels), and the dict of the route changes it
    counted."""
    log, changes = [], {"changed": 0, "tokens": 0}

    def wrap(fn):
        def run(*args):
            with pinned_routes(log, changes):
                return fn(*args)
        return run
    return wrap, changes


def moe_flagship(device, root: Path, workdir: Path, learned: dict) -> dict:
    """Phase 16b: ``__graft_entry__.entry()``'s arch as
    ``transformer_moe_discrete`` (4 experts, top-2: the recall_moe golden's
    settings). ``evaluate`` through K1 against the plain attention (phase
    4's bar); the first REINFORCE update on phase 5's first batch through
    K1-K3 against the plain attention (phase 5's bars) at exactly n_layers
    x 84 K1 and n_layers K2 and K3; in both the plain side's routes are
    pinned to the kernels' (:func:`pinned_routes`, which counts the route
    changes the pin held off). ``expert_utilization`` sums to 1 in every
    layer; the cached decode against the window over one episode, in f32
    at the f32 bar, and in bf16 at phase 10's bars with the cached side's
    routes pinned to the window's (:func:`routes_from_window`). Then the
    recall_moe golden (:func:`recall_moe_golden`) until an epoch's average
    return reaches 1.0, within ``MOE_GOLDEN_MAX_UPDATES`` updates."""
    import shutil
    from types import SimpleNamespace

    import torch

    from relayrl_tpu_torch.models.moe import expert_utilization

    shutil.rmtree(workdir, ignore_errors=True)
    algo = build_learner(device, workdir / "learner", MOE_ARCH)
    params0 = copy.deepcopy(algo.state.params)
    zero_flash_counts()
    eval_pin, eval_changes = route_pinning()
    eval_err = compare_evaluate(SimpleNamespace(arch=algo.arch, params=params0,
                                                policy=algo.policy), device, eval_pin)
    eval_counts = flash_counts()
    if not eval_err <= TOLERANCE["bfloat16"]:
        raise AssertionError(f"MoE evaluate kernel vs plain attention: {eval_err}")
    zero_flash_counts()
    update_pin, update_changes = route_pinning()
    cmp = compare_update(algo, params0, learned["batch"], device, plain_flash,
                         wrap=update_pin)
    torch.cuda.synchronize()
    launches = flash_counts()
    n_layers = MOE_ARCH["n_layers"]
    expected = (n_layers * (4 + algo.train_vf_iters), n_layers, n_layers)
    if launches != expected:
        raise AssertionError(f"MoE update launches {launches}, expected {expected}")
    util = expert_utilization(algo.arch, params0, learned["batch"]["obs"])
    if (sorted(util) != [f"block_{i}" for i in range(n_layers)]
            or not all(abs(float(u.sum()) - 1.0) <= 1e-5 for u in util.values())):
        raise AssertionError(f"MoE expert utilization {util}")
    # In f32 at the f32 bar; then as served, in bf16, whose rounding that
    # differs between the cached and the window step changes near-tied
    # routes (pinned_routes): those routes pinned to the window's.
    decode = check_cached_decode(device, {**slice_arch(), **MOE_ARCH,
                                          "precision": "float32"}, episodes=1)
    decode_bf16 = check_cached_decode(device, {**slice_arch(), **MOE_ARCH}, episodes=1,
                                      pin_routes=True)

    import os

    zero_flash_counts()
    golden = recall_moe_golden(device, root, workdir / "golden", MOE_GOLDEN_MAX_UPDATES)
    stalled = None
    if golden["curve"][-1] < 1.0:
        stalled = golden
        print(f"[moe] recall_moe golden stalled at the process id's salt: AverageEpRet "
              f"{golden['curve'][-5:]} after {len(golden['curve'])} updates; "
              f"{golden_readout_text(golden['readout'])}; a second salt", flush=True)
        golden = recall_moe_golden(device, root, workdir / "golden2", MOE_GOLDEN_MAX_UPDATES,
                                   os.getpid() + MOE_GOLDEN_SECOND_SALT)
    curve = golden["curve"]
    if curve[-1] < 1.0 or any(flash_counts()):
        raise AssertionError(f"recall_moe golden: AverageEpRet {curve[-5:]} after "
                             f"{len(curve)} updates at the second salt too; flash launches "
                             f"{flash_counts()}")
    return {"eval_err": eval_err, "eval_changes": eval_changes,
            "update_changes": update_changes, "eval_launches": eval_counts[0],
            "launches": launches,
            "util": {k: [round(float(x), 4) for x in v] for k, v in util.items()},
            "decode": decode, "decode_bf16": decode_bf16,
            "golden_updates": len(curve), "golden_wall": golden["wall"],
            "golden_stalled": stalled is not None,
            "golden_steps": golden["steps"], "golden_first": curve[0], **cmp}


def recall_moe_golden(device, root: Path, workdir: Path, max_updates: int,
                      seed_salt: int | None = None) -> dict:
    """The recall_moe golden's ``config.json`` (uncut, dense attention: no
    kernel) through ``LocalRunner`` until an epoch's average return reaches
    1.0, or for ``max_updates`` updates. ``seed_salt`` replaces the
    learner's own (the process id) where given. Returns the per-update
    average returns, the wall seconds and the env steps."""
    import io

    import torch

    from relayrl_tpu_torch.envs import RecallEnv
    from relayrl_tpu_torch.runtime import LocalRunner

    cfg = json.loads((root / "examples" / "golden" / "recall_moe" / "config.json").read_text())
    hp = {k: v for k, v in cfg.items()
          if k not in ("algorithm", "exp_name", "obs_dim", "act_dim", "discrete")}
    if seed_salt is not None:
        hp["seed_salt"] = seed_salt
    runner = LocalRunner(RecallEnv(horizon=8), cfg["algorithm"],
                         config_path=_local_config(workdir), env_dir=str(workdir),
                         device=device, **hp)
    if (runner.algorithm.arch["kind"] != "transformer_moe_discrete"
            or runner.actor.policy.input_dim != cfg["obs_dim"]):
        raise AssertionError(f"recall_moe learner {runner.algorithm.arch}")
    per_epoch = int(cfg["traj_per_epoch"])
    t0 = time.perf_counter()
    curve = []
    while len(curve) < max_updates:
        with contextlib.redirect_stdout(io.StringIO()):  # the epoch log
            result = runner.train(epochs=1)
        curve.append(sum(result["returns"][-per_epoch:]) / per_epoch)
        if curve[-1] >= 1.0:
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"curve": curve, "wall": wall, "steps": runner.actor.steps_served,
            "readout": golden_readout(runner)}


def golden_readout(runner) -> dict:
    """What a recall_moe run has learned: the last update's policy entropy,
    the query step's action probabilities for each cue (the window of one
    episode: the cue at t = 0, the query flag at the last step), and each
    layer's expert utilization over those windows."""
    import numpy as np
    import torch

    from relayrl_tpu_torch.algorithms.onpolicy import read_metrics
    from relayrl_tpu_torch.models.moe import expert_utilization

    algo, env = runner.algorithm, runner.env
    obs = np.zeros((env.n_cues, env.horizon, env.n_cues + 2), np.float32)
    for cue in range(env.n_cues):
        obs[cue, 0, cue] = 1.0
        obs[cue, -1, env.n_cues] = 1.0
        obs[cue, :, env.n_cues + 1] = np.arange(env.horizon) / env.horizon
    params = algo.state.params
    with torch.no_grad():
        logits, _ = params(torch.as_tensor(obs, device=algo.device))
    util = expert_utilization(algo.arch, params, obs)
    return {"entropy": read_metrics(algo._last_metrics).get("Entropy"),
            "query_probs": torch.softmax(logits[:, -1], -1).cpu().numpy().round(4).tolist(),
            "utilization": {k: [round(float(x), 4) for x in v] for k, v in util.items()}}


def golden_readout_text(readout: dict) -> str:
    return (f"policy entropy {readout['entropy']:.4f}, query-step action probabilities "
            f"per cue {readout['query_probs']}, expert utilization {readout['utilization']}")


def moe_golden_sweep(device, root: Path, workdir: Path, salts: range,
                     max_updates: int) -> int:
    """:func:`recall_moe_golden` over ``seed_salt`` in ``salts``, each for
    at most ``max_updates`` updates: prints per salt the updates it took to
    an epoch of average return 1.0 (or that it did not get there), then
    the sorted counts. Gates nothing; returns 0."""
    import shutil

    took = []
    for salt in salts:
        shutil.rmtree(workdir / str(salt), ignore_errors=True)
        run = recall_moe_golden(device, root, workdir / str(salt), max_updates, salt)
        reached = run["curve"][-1] >= 1.0
        took.append(len(run["curve"]) if reached else None)
        print(f"[moe-golden-sweep] salt {salt}: "
              + (f"1.0 at update {len(run['curve'])}" if reached
                 else f"not at 1.0 after {max_updates} updates (last {run['curve'][-1]:.3f})")
              + f", {run['wall']:.2f} s; {golden_readout_text(run['readout'])}", flush=True)
    print(f"[moe-golden-sweep] updates to 1.0 over salts {salts.start}..{salts.stop - 1}: "
          f"{sorted(t for t in took if t is not None)}; {took.count(None)} not there "
          f"within {max_updates}", flush=True)
    return 0


def pp_flagship(device, workdir: Path, learned: dict) -> dict:
    """Phase 16c: ``__graft_entry__.entry()``'s arch as
    ``transformer_pp_discrete``. The flagship ``transformer_discrete``'s
    weights, stacked into the ``blocks`` layout, give its ``evaluate`` bit
    for bit on the card (both through K1); the first REINFORCE update on
    phase 5's first batch through K1-K3 against the plain attention (phase
    5's bars) at phase 5's launch counts."""
    import shutil

    import numpy as np
    import torch

    from relayrl_tpu_torch.models import build_policy
    from relayrl_tpu_torch.weights import params_to_jax

    shutil.rmtree(workdir, ignore_errors=True)
    plain_policy = build_policy(slice_arch(), device)
    pp_policy = build_policy({**slice_arch(), "kind": PP_ARCH["kind"]}, device)
    tree = params_to_jax(plain_policy.init_params(torch.Generator().manual_seed(SEED)))
    inner = dict(tree["params"])
    layers = [inner.pop(f"block_{i}") for i in range(PP_ARCH["n_layers"])]
    inner["blocks"] = {scope: {name: np.stack([layer[scope][name] for layer in layers])
                               for name in layers[0][scope]} for scope in layers[0]}
    obs = torch.as_tensor(learned["batch"]["obs"], device=device)
    act = torch.as_tensor(learned["batch"]["act"], device=device)
    with torch.inference_mode():
        want = plain_policy.evaluate(plain_policy.load_params(tree), obs, act)
        got = pp_policy.evaluate(pp_policy.load_params({"params": inner}), obs, act)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("pp evaluate vs transformer_discrete: max abs diff "
                             f"{max((a - b).abs().max().item() for a, b in zip(got, want))}")
    algo = build_learner(device, workdir / "learner", PP_ARCH)
    params0 = copy.deepcopy(algo.state.params)
    zero_flash_counts()
    cmp = compare_update(algo, params0, learned["batch"], device, plain_flash)
    torch.cuda.synchronize()
    launches = flash_counts()
    n_layers = PP_ARCH["n_layers"]
    expected = (n_layers * (4 + algo.train_vf_iters), n_layers, n_layers)
    if launches != expected:
        raise AssertionError(f"pp update launches {launches}, expected {expected}")
    return {"launches": launches, "rows": tuple(obs.shape[:2]), **cmp}


# -- phase 17: the anakin tier -------------------------------------------------

def _window_copy(host) -> dict:
    """The device window as fresh numpy arrays (flat keys, aux prefixed)."""
    w = host.window_to_host()
    out = {k: w[k].copy() for k in ("obs", "act", "rew", "term", "trunc", "final_obs")}
    out.update({f"aux.{k}": v.copy() for k, v in w["aux"].items()})
    return out


def _carry_copy(host) -> dict:
    carry = host.snapshot()[0]
    out = {f"state.{i}": t.cpu().numpy() for i, t in enumerate(carry["state"])}
    out.update({k: v.cpu().numpy() for k, v in carry.items() if k != "state"})
    return out


def graph_vs_eager(host) -> list:
    """One window by graph replay and the same window run eagerly, from the
    same carry and generator states. Returns the keys (window, aux and the
    carry after) whose bytes differ."""
    snap = host.snapshot()
    host.produce()
    graph, graph_carry = _window_copy(host), _carry_copy(host)
    host.restore(snap)
    host.produce(eager=True)
    eager, eager_carry = _window_copy(host), _carry_copy(host)
    return ([k for k in graph if graph[k].tobytes() != eager[k].tobytes()]
            + [k for k in graph_carry if graph_carry[k].tobytes() != eager_carry[k].tobytes()])


def window_ms(host, n: int, eager: bool = False) -> float:
    """Milliseconds per window on the device (replay or eager), ending in a
    device sync, over ``n`` windows after one untimed."""
    import torch

    host.produce(eager=eager)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        host.produce(eager=eager)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


def device_envs_card_vs_cpu(device) -> dict:
    """Phase 17a: each of the six device envs, ``ANAKIN_ENV_LANES`` lanes
    for ``ANAKIN_ENV_STEPS`` steps on actions drawn with numpy from a seed:
    before every step the card's env takes the CPU side's state (re-anchored,
    so a one-ulp difference never compounds), both step, and every state
    field, observation, reward and flag is compared: exactly for the
    integer envs and every integer or bool field, to ``ANAKIN_ENV_TOL``
    (absolute plus relative) for CartPole's and Pendulum's floats. The CPU
    side then autoresets from its generator. Returns the largest float
    difference per env."""
    import numpy as np
    import torch

    from relayrl_tpu_torch.envs.device import make_device, step_autoreset

    worst = {}
    for env_id, kwargs in ANAKIN_ENVS.items():
        cpu = make_device(env_id, device="cpu", **kwargs)
        card = make_device(env_id, device=device, **kwargs)
        gen = torch.Generator().manual_seed(SEED)
        rng = np.random.default_rng(SEED)
        state, _ = cpu.reset(gen, ANAKIN_ENV_LANES)
        worst[env_id] = 0.0
        for step in range(ANAKIN_ENV_STEPS):
            if env_id == "Pendulum-v1":
                act = torch.as_tensor(rng.uniform(-2.5, 2.5, (ANAKIN_ENV_LANES, 1))
                                      .astype(np.float32))
            else:
                act = torch.as_tensor(rng.integers(cpu.action_space.n, size=ANAKIN_ENV_LANES)
                                      .astype(np.int32))
            want = cpu.step(state, act)
            got = card.step(type(state)(*(t.to(device) for t in state)), act.to(device))
            for name, g, w in zip([f"state.{f}" for f in state._fields]
                                  + ["obs", "reward", "terminated", "truncated"],
                                  [*got[0], *got[1:]], [*want[0], *want[1:]]):
                g = g.cpu()
                if g.dtype != w.dtype or g.shape != w.shape:
                    raise AssertionError(f"{env_id} {name}: {g.dtype} {tuple(g.shape)} on "
                                         f"the card, {w.dtype} {tuple(w.shape)} on the cpu")
                if env_id in ANAKIN_FLOAT_ENVS and g.is_floating_point():
                    err = (g - w).abs()
                    if not bool((err <= ANAKIN_ENV_TOL * (1 + w.abs())).all()):
                        raise AssertionError(f"{env_id} {name} at step {step}: card vs cpu "
                                             f"{err.max().item():.3e}")
                    worst[env_id] = max(worst[env_id], err.max().item())
                elif not torch.equal(g, w):
                    raise AssertionError(f"{env_id} {name} at step {step}: card != cpu")
            state = step_autoreset(cpu, state, act, gen)[0]
    return worst


def anakin_mlp(device, root: Path, workdir: Path) -> dict:
    """Phase 17b: the cartpole_reinforce_baseline golden's ``mlp_discrete``
    (its ``config.json``, random weights from the learner's seed) on device
    CartPole, ``ANAKIN_MLP_LANES`` lanes, ``ANAKIN_UNROLL`` steps a window,
    captured as a CUDA graph. The graph's window equals the eager window bit
    for bit from the same generator states; a replay from the same carry and
    policy generator but the env generator one replay on diverges in the
    resets alone, and one from the env generator but the policy generator
    one replay on acts differently at its first step (both generators
    advance inside the graph); ``final_obs`` equals the next ``obs`` wherever
    a lane did not end, and every autoreset lane starts inside CartPole's
    reset box; no flash or ring kernel launches. Returns the windows' times,
    graph and eager."""
    import numpy as np
    import torch

    from relayrl_tpu_torch.algorithms import build_algorithm
    from relayrl_tpu_torch.runtime.anakin import AnakinActorHost

    cfg = json.loads((root / "examples" / "golden" / "cartpole_reinforce_baseline"
                      / "config.json").read_text())
    hp = {k: v for k, v in cfg.items()
          if k not in ("algorithm", "exp_name", "obs_dim", "act_dim", "discrete")}
    algo = build_algorithm(cfg["algorithm"], obs_dim=cfg["obs_dim"], act_dim=cfg["act_dim"],
                           device=device, env_dir=str(workdir),
                           config_path=_local_config(workdir), **hp)
    if algo.arch["kind"] != "mlp_discrete":
        raise AssertionError(f"cartpole golden arch {algo.arch}")
    zero_flash_counts()
    zero_ring_counts()
    host = AnakinActorHost(algo.bundle(), "CartPole-v1", num_envs=ANAKIN_MLP_LANES,
                           unroll_length=ANAKIN_UNROLL, seed=SEED, device=device)
    differs = graph_vs_eager(host)
    if differs:
        raise AssertionError(f"MLP window: graph != eager in {differs}")
    snap = host.snapshot()
    host.produce()
    first = _window_copy(host)
    pol1, env1 = host._pol_gen.get_state(), host._env_gen.get_state()
    host.restore((snap[0], snap[1], env1))
    host.produce()
    env_on = _window_copy(host)
    host.restore((snap[0], pol1, snap[2]))
    host.produce()
    pol_on = _window_copy(host)
    if not (np.array_equal(env_on["act"][:, 0], first["act"][:, 0])
            and not np.array_equal(env_on["obs"], first["obs"])):
        raise AssertionError("the env generator did not advance inside the graph")
    if np.array_equal(pol_on["act"][:, 0], first["act"][:, 0]):
        raise AssertionError("the policy generator did not advance inside the graph")
    done = first["term"] | first["trunc"]
    going = ~done[:, :-1]
    if not np.array_equal(first["final_obs"][:, :-1][going], first["obs"][:, 1:][going]):
        raise AssertionError("final_obs != the next obs on a lane that did not end")
    starts = first["obs"][:, 1:][done[:, :-1]]
    if starts.size == 0 or np.abs(starts).max() > 0.05:
        raise AssertionError(f"autoreset starts outside CartPole's reset box: "
                             f"{np.abs(starts).max() if starts.size else 'none'}")
    graph_ms = window_ms(host, ANAKIN_TIMED)
    eager_ms = window_ms(host, ANAKIN_TIMED, eager=True)
    counts = flash_counts() + ring_counts()
    if any(counts) or any(host.captured_launches):
        raise AssertionError(f"flash/ring kernels on the MLP window: {counts}, captured "
                             f"{host.captured_launches}")
    return {"graph_ms": graph_ms, "eager_ms": eager_ms, "resets": int(done.sum()),
            "hidden": list(hp["hidden_sizes"])}


def anakin_flagship(device, workdir: Path) -> dict:
    """Phase 17c: phase 4's configuration on the anakin tier: the flagship
    arch on device ``Recall-v0`` (horizon ``HORIZON``, ``N_CUES`` cues),
    ``LANES`` lanes, ``ANAKIN_UNROLL`` steps a window over a 256-row rolling
    window, captured as one CUDA graph. The capture holds exactly 3 K1 per
    step (every layer but the readout layer's), so a replay launches
    ``3 x ANAKIN_UNROLL``; the graph equals the eager window bit for bit,
    before and after a hot swap (the swap copies the new params into the
    graph's tensors: the installed params' sha256 equals the bundle's);
    each shipped step's ``logp_a`` equals the log-prob of its action on the
    same window contents through the plain attention (phase 4's bar); every
    columnar frame of ``ANAKIN_SEQ_WINDOWS`` windows decodes through
    ``parse_frame`` with the episode's length and its terminal marker.
    Returns the launches, the errors and the times."""
    import numpy as np
    import torch

    from relayrl_tpu_torch.models import build_policy
    from relayrl_tpu_torch.runtime.anakin import AnakinActorHost
    from relayrl_tpu_torch.runtime.policy_actor import window_advance
    from relayrl_tpu_torch.types import ModelBundle
    from relayrl_tpu_torch.types.columnar import parse_frame
    from relayrl_tpu_torch.weights import params_to_jax, tree_digest

    arch = slice_arch()
    policy = build_policy(arch, device)
    v1, v2 = (ModelBundle(version, arch, params_to_jax(policy.init_params(
        torch.Generator().manual_seed(SEED + version)))) for version in (1, 2))
    frames = [[] for _ in range(LANES)]
    zero_flash_counts()
    host = AnakinActorHost(v1, "Recall-v0", num_envs=LANES, unroll_length=ANAKIN_UNROLL,
                           seed=SEED, device=device, horizon=HORIZON, n_cues=N_CUES,
                           on_send=lambda lane, p: frames[lane].append(p))
    build_counts = flash_counts()
    per_window = (arch["n_layers"] - 1) * ANAKIN_UNROLL
    if (host.captured_launches != (per_window, 0, 0, 0, 0, 0)
            or build_counts != (arch["n_layers"] + 2 * per_window, 0, 0)):
        raise AssertionError(f"flagship window: captured launches {host.captured_launches}, "
                             f"expected {per_window} K1; construction {build_counts} "
                             f"(validate, warm-up and capture)")
    if host._window_size != arch["max_seq_len"]:
        raise AssertionError(f"window {host._window_size}")

    # The main path: ANAKIN_SEQ_WINDOWS windows through rollout() (replay,
    # copy out, columnar emit); the replays run no Python launch counter.
    zero_flash_counts()
    replays0 = host.replays
    t0 = time.perf_counter()
    for _ in range(ANAKIN_SEQ_WINDOWS):
        host.rollout()
    wall = time.perf_counter() - t0
    replays = host.replays - replays0
    if flash_counts() != (0, 0, 0) or replays != ANAKIN_SEQ_WINDOWS:
        raise AssertionError(f"replays {replays} counted {flash_counts()}")
    n_frames = 0
    for lane, lane_frames in enumerate(frames):
        if not lane_frames:
            raise AssertionError(f"lane {lane} shipped no frame")
        for payload in lane_frames:
            dt = parse_frame(payload, agent_id=f"lane{lane}")
            cols = dt.columns
            ok = (dt.n_steps == HORIZON and dt.n_records == HORIZON + 1
                  and not dt.marker_truncated and dt.final_obs is None
                  and cols["o"].shape == (HORIZON, arch["obs_dim"])
                  and cols["o"].dtype == np.float32 and cols["a"].dtype == np.int32
                  and cols["t"][-1] == 1 and not cols["t"][:-1].any() and not cols["x"].any()
                  and sorted(dt.aux) == ["logp_a", "v"])
            if not ok:
                raise AssertionError(f"lane {lane}: frame of {dt.n_steps} steps, "
                                     f"{dt.n_records} records, columns "
                                     f"{ {k: (v.dtype, v.shape) for k, v in cols.items()} }")
            n_frames += 1

    # logp_a against the plain attention on the same window contents.
    snap = host.snapshot()
    host.produce()
    w = _window_copy(host)
    plain = copy.deepcopy(host._live)
    for block in plain.layers():
        block.attn_fn = plain_flash
    win, wlen = snap[0]["win"], snap[0]["wlen"]
    logp_err = 0.0
    with torch.no_grad():
        for u in range(ANAKIN_UNROLL):
            obs = torch.as_tensor(w["obs"][:, u], device=device)
            win, wlen = window_advance(win, wlen, obs)
            logits, _ = plain(win, None, readout_t=(wlen.long() - 1).clamp(0, win.shape[1] - 1))
            act = torch.as_tensor(w["act"][:, u], device=device).long()
            logp = torch.log_softmax(logits, -1).gather(-1, act[:, None])[:, 0]
            logp_err = max(logp_err, (logp.cpu() - torch.as_tensor(w["aux.logp_a"][:, u]))
                           .abs().max().item())
            done = torch.as_tensor(w["term"][:, u] | w["trunc"][:, u], device=device)
            win = torch.where(done[:, None, None], 0.0, win)
            wlen = torch.where(done, 0, wlen)
    if not logp_err <= TOLERANCE["bfloat16"]:
        raise AssertionError(f"shipped logp_a vs the plain attention: {logp_err}")
    differs = graph_vs_eager(host)
    if differs:
        raise AssertionError(f"flagship window: graph != eager in {differs}")
    graph_ms = window_ms(host, ANAKIN_TIMED)
    eager_ms = window_ms(host, ANAKIN_TIMED, eager=True)
    # A hot swap between windows: the next window reads the new params.
    if not host.maybe_swap(v2):
        raise AssertionError("hot swap refused")
    live = host._live
    host.rollout()
    digest = tree_digest(params_to_jax(host._live))
    if host._live is not live or digest != tree_digest(v2.params) or host.version != 2:
        raise AssertionError("the swap did not copy v2 into the graph's params")
    swapped = graph_vs_eager(host)
    if swapped:
        raise AssertionError(f"flagship window after the swap: graph != eager in {swapped}")
    return {"launches": per_window * replays, "per_replay": per_window,
            "replays": replays, "wall": wall,
            "frames": n_frames, "logp_err": logp_err, "graph_ms": graph_ms,
            "eager_ms": eager_ms, "digest": digest}


def anakin_distributed(device, root: Path, workdir: Path) -> dict:
    """Phase 17d: phase 11's REINFORCE learner (16 episodes an epoch, so
    one wave of ``LANES`` episodes is ``ANAKIN_UPDATES`` updates) in a
    ``chaos_server`` process over ZMQ, fed by one anakin ``VectorAgent`` of
    phase 17c's configuration on ``Recall-v0`` at ``LEARNER_HORIZON`` (the
    learner's 256 bucket), columnar frames, ``record_bver`` on. One wave of
    windows, then: the server counts columnar frames, trains
    ``ANAKIN_UPDATES`` updates at 336/4/4 launches each, accepts exactly
    what each lane sent; the agent installs every publish sha256-equal to
    it; the next window runs at the new version (its ``bver``)."""
    import shutil

    from relayrl_tpu_torch.runtime.agent import VectorAgent
    from relayrl_tpu_torch.weights import params_to_jax, tree_digest

    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    server_addrs, agent_addrs = zmq_addrs()
    arch = slice_arch()
    learner = {**LEARNER, "traj_per_epoch": LANES // ANAKIN_UPDATES}
    hyperparams = {"model_kind": arch["kind"], "seed": SEED, "seed_salt": 0,
                   **{k: v for k, v in SLICE_ARCH.items()
                      if k not in ("kind", "has_critic", "precision")}, **learner}
    cfg = {"algorithm": "REINFORCE", "obs_dim": arch["obs_dim"], "act_dim": arch["act_dim"],
           "hyperparams": hyperparams, "device": str(device),
           "scratch": str(workdir / "server"),
           "config": {"learner": {"precision": arch["precision"]}},
           "digests": True, "status_path": str(workdir / "status.json"), **server_addrs}
    agent_config = workdir / "agent_config.json"
    agent_config.write_text(json.dumps({}))
    per_update = (arch["n_layers"] * (4 + LEARNER["train_vf_iters"]), arch["n_layers"],
                  arch["n_layers"])
    server = ChaosServer(root, cfg, workdir / "server.log")
    agent = None
    try:
        server.wait(lambda s: True, "the server to come up")
        zero_flash_counts()
        agent = VectorAgent(num_envs=LANES, config_path=str(agent_config), seed=SEED,
                            probe=False, device=device, host_mode="anakin",
                            jax_env="Recall-v0",
                            jax_env_kwargs={"horizon": LEARNER_HORIZON, "n_cues": N_CUES},
                            unroll_length=ANAKIN_UNROLL, record_bver=True,
                            model_path=str(workdir / "client_model.rlx"), **agent_addrs)
        host = agent.host
        if not agent.columnar_wire or host.graph is None:
            raise AssertionError("the anakin agent runs no captured columnar window")
        installs, bvers = [], []
        swap = host.swap_from_wire

        def swap_and_log(version, blob):
            got = swap(version, blob)
            if got is not None:
                with host._lock:
                    installs.append((host.version, tree_digest(params_to_jax(host.params))))
            return got

        host.swap_from_wire = swap_and_log
        emit = host._emit_columnar

        def emit_and_log(w):
            bvers.append(sorted(set(w["aux"]["bver"].ravel().tolist())))
            return emit(w)

        host._emit_columnar = emit_and_log
        replays0 = host.replays
        t0 = time.perf_counter()
        for _ in range(-(-LEARNER_HORIZON // ANAKIN_UNROLL)):
            agent.rollout()
        wall = time.perf_counter() - t0
        wave = host.replays - replays0
        status = server.wait(
            lambda s: (s["stats"]["updates"] == ANAKIN_UPDATES
                       and agent.model_version == ANAKIN_UPDATES
                       and (s.get("published") or {}).get("version") == ANAKIN_UPDATES),
            f"{ANAKIN_UPDATES} updates published and installed")
        agent.rollout()  # the next window, at the installed version
        stats = status["stats"]
        if stats["learner_errors"] or stats["dropped"] or stats["publish_errors"]:
            raise AssertionError(f"server stats {stats}: {status['last_learner_error']}")
        kernels = status["kernels"]
        server_counts = (kernels["flash_fwd"], kernels["flash_dq"], kernels["flash_dkv"])
        if server_counts != tuple(ANAKIN_UPDATES * c for c in per_update):
            raise AssertionError(f"server launches {server_counts} over {ANAKIN_UPDATES} "
                                 f"updates; expected {ANAKIN_UPDATES} x {per_update}")
        frames = _counter(status, "relayrl_server_columnar_frames_total")
        if frames < LANES:
            raise AssertionError(f"the server counted {frames} columnar frames")
        sent = agent.spool.sent_counts()
        for lane in agent.agent_ids:
            row = status["accounting"]["agents"].get(lane)
            if row != {"max_seq": sent[lane], "accepted": sent[lane], "contiguous": True}:
                raise AssertionError(f"ingest accounting of {lane}: {row}, sent {sent[lane]}")
        log = status["published_log"]
        if (not installs or [v for v, _ in installs][-1] != ANAKIN_UPDATES
                or any(log.get(str(v)) != d for v, d in installs)):
            raise AssertionError(f"installs {installs} vs published {log}")
        if bvers[-1] != [ANAKIN_UPDATES] or bvers[0] != [0]:
            raise AssertionError(f"bver per window {bvers}")
        agent_counts = flash_counts()
        per_replay = host.captured_launches[0]
        if agent_counts != (arch["n_layers"] + 2 * per_replay, 0, 0):
            raise AssertionError(f"agent launches at construction {agent_counts}")
        return {"updates": stats["updates"], "server_counts": server_counts,
                "per_update": per_update, "frames": frames, "installs": installs,
                "agent_launches": per_replay * (host.replays - replays0),
                "windows": host.replays - replays0, "wave_windows": wave, "wall": wall,
                "bvers": bvers}
    finally:
        if agent is not None:
            agent.disable_agent()
        server.stop()


def serving_config(workdir: Path, **sections) -> str:
    """A config file for phase 18's clients and servers: generous serving
    budgets (the first dispatch at a bucket is slow), no spool for a
    trajectory sink that never acks, plus ``sections``."""
    workdir.mkdir(parents=True, exist_ok=True)
    serving = {"request_timeout_s": 60.0, "infer_deadline_s": 240.0,
               **sections.pop("serving", {})}
    config = workdir / "relayrl_config.json"
    config.write_text(json.dumps({"serving": serving, **sections}))
    return str(config)


class DispatchLog:
    """Records every dispatch of ``svc`` by wrapping its own dispatch
    methods (the service keeps no log): the requests' session and step,
    the params and version it read, the keyed step's inputs and outputs
    and the step's host time. ``close()`` puts the methods back."""

    def __init__(self, svc):
        self.svc, self.entries, self.step_s = svc, [], []
        windowed = svc._window_fn is not None
        self._names = (("_window_fn", "_dispatch_window_group") if windowed
                       else ("_batched_fn", "_dispatch_group"))
        self.step = getattr(svc, self._names[0])
        group_fn = getattr(svc, self._names[1])
        pending = []

        def step(params, *inputs):
            t0 = time.perf_counter()
            out = self.step(params, *inputs)
            self.step_s.append(time.perf_counter() - t0)
            pending.append((inputs, out))
            return out

        def dispatch(group, params, version, *rest):
            group_fn(group, params, version, *rest)
            inputs, outputs = pending.pop()
            self.entries.append({
                "rows": len(group), "bucket": len(inputs[0]), "params": params,
                "version": version, "inputs": inputs, "outputs": outputs,
                "requests": [(r.sid, r.stp) for r in group]})

        setattr(svc, self._names[0], step)
        setattr(svc, self._names[1], dispatch)

    def close(self) -> None:
        setattr(self.svc, self._names[0], self.step)  # an instance attribute
        del self.svc.__dict__[self._names[1]]  # back to the class's method

    def replay(self) -> int:
        """Every logged dispatch run again through the keyed step on the
        same inputs and params: the served actions, aux and successor keys
        must come back bit for bit. Returns the dispatches checked."""
        for i, entry in enumerate(self.entries):
            acts, aux, keys = self.step(entry["params"], *entry["inputs"])
            s_acts, s_aux, s_keys = entry["outputs"]
            bad = [name for name, a, b in [("act", acts, s_acts), ("key", keys, s_keys)]
                   + [(k, aux[k], s_aux[k]) for k in aux] if a.tobytes() != b.tobytes()]
            if bad:
                raise AssertionError(f"dispatch {i} (bucket {entry['bucket']}, version "
                                     f"{entry['version']}): served != local in {bad}")
        return len(self.entries)

    def served_rows(self) -> dict:
        """``{(session, step): (act, logp_a, v)}`` over every logged row;
        a step dispatched twice (a retried push) must have served the same
        bytes both times."""
        rows = {}
        for entry in self.entries:
            acts, aux, _ = entry["outputs"]
            for i, req in enumerate(entry["requests"]):
                row = (acts[i], aux["logp_a"][i], aux["v"][i])
                if req in rows and any(a.tobytes() != b.tobytes()
                                       for a, b in zip(rows[req], row)):
                    raise AssertionError(f"session {req[0]} step {req[1]} served twice "
                                         f"with different bytes")
                rows[req] = row
        return rows


def time_keyed_draws(device, rows: int, act_dim: int, reps: int = 50) -> dict:
    """Host ms of the keyed draw alone at ``rows`` rows: ``KeyedDraws``
    construction (a numpy Philox a row and its successor key) and one
    ``[rows, act_dim]`` uniform block copied to the card, as a categorical
    policy's dispatch asks for it; each rep synchronised."""
    import numpy as np
    import torch

    from relayrl_tpu_torch.models.mlp import KeyedDraws

    keys = np.random.default_rng(SEED).integers(0, 1 << 32, (rows, 2), dtype=np.uint32)
    build_s, draw_s = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        draws = KeyedDraws(keys, device)
        t1 = time.perf_counter()
        draws.uniform((rows, act_dim))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        build_s.append(t1 - t0)
        draw_s.append(t2 - t1)
    return {"build_ms": 1e3 * float(np.median(build_s)),
            "draw_ms": 1e3 * float(np.median(draw_s))}


def served_flagship(device, workdir: Path, per_dispatch: int,
                    steps: int = SERVE_STEPS, traced: bool = False) -> dict:
    """Phase 18 (a): the flagship served over ZMQ to a multiplexed thin
    client for ``steps`` env steps. Checks served == the keyed window step
    at the same bucket for every dispatch, K1 launches == dispatches x
    ``per_dispatch``, no K2/K3, every lane's episode shipped (when
    ``steps`` outlasts an episode); measures the cross-bucket difference,
    requests/s and ms per dispatch on the host and on the device.
    ``traced`` (phase 20, the process tracer live): every request's
    ``serve`` trace holds one ``queue`` and one ``dispatch`` span, and the
    device timings are skipped."""
    import collections

    import numpy as np
    import torch

    from relayrl_tpu_torch.config import ConfigLoader
    from relayrl_tpu_torch.envs import RecallEnv, SyncVectorEnv
    from relayrl_tpu_torch.models import build_policy
    from relayrl_tpu_torch.runtime.inference import (
        InferenceService,
        MultiplexedRemoteClient,
    )
    from relayrl_tpu_torch.runtime.vector_actor import run_vector_gym_loop
    from relayrl_tpu_torch.transport import make_server_transport
    from relayrl_tpu_torch.types import ModelBundle, deserialize_actions
    from relayrl_tpu_torch.weights import params_to_jax

    arch = slice_arch()
    policy = build_policy(arch, device)
    bundle = ModelBundle(1, arch, params_to_jax(policy.init_params(
        torch.Generator().manual_seed(SEED + 1))))
    config = serving_config(workdir, serving={"stream_window": LANES},
                            actor={"spool_entries": 0})
    server_addrs, agent_addrs = zmq_addrs()
    sink = make_server_transport("zmq", ConfigLoader(None, config), **server_addrs)
    shipped = []
    sink.on_trajectory = lambda agent_id, payload: shipped.append((agent_id, payload))
    sink.start()
    serving_addr = f"tcp://127.0.0.1:{_free_port()}"
    svc = InferenceService(bundle, max_batch=LANES, batch_timeout_ms=5.0, device=device)
    svc.bind_zmq(serving_addr)
    svc.start()
    mux = None
    try:
        mux = MultiplexedRemoteClient(config_path=config, lanes=LANES, seed=SEED,
                                      probe=False, serving_addr=serving_addr,
                                      **agent_addrs)
        venv = SyncVectorEnv([lambda: RecallEnv(HORIZON, N_CUES)] * LANES)
        log = DispatchLog(svc)
        zero_flash_counts()
        t0 = time.perf_counter()
        spans0 = len(trace_spans())
        run_vector_gym_loop(mux, venv, steps, seed=SEED)
        wall = time.perf_counter() - t0
        counts = flash_counts()
        log.close()
        keyed, entries = log.step, log.entries
        dispatches = len(entries)
        if counts != (dispatches * per_dispatch, 0, 0):
            raise AssertionError(f"served launches {counts} over {dispatches} dispatches; "
                                 f"expected {per_dispatch} flash_fwd each")
        if mux.model_version != 1:
            raise AssertionError(f"client at version {mux.model_version}")
        checked = log.replay()
        # Across buckets: a bucket-LANES dispatch's first rows at smaller
        # buckets (the same rows, another M for cuBLAS and K1).
        full = next(e for e in reversed(entries) if e["bucket"] == LANES)
        keys, windows, ts, masks = full["inputs"]
        acts, aux, _ = full["outputs"]
        cross = {}
        for bucket in SERVE_OTHER_BUCKETS:
            b_acts, b_aux, _ = keyed(full["params"], keys[:bucket], windows[:bucket],
                                     ts[:bucket], None)
            cross[bucket] = {
                "acts_differ": int((b_acts != acts[:bucket]).sum()),
                "logp_a": float(np.abs(b_aux["logp_a"] - aux["logp_a"][:bucket]).max()),
                "v": float(np.abs(b_aux["v"] - aux["v"][:bucket]).max())}
            if cross[bucket]["acts_differ"] or not cross[bucket]["logp_a"] <= TOLERANCE["bfloat16"]:
                raise AssertionError(f"bucket {bucket} vs {LANES}: {cross[bucket]}")
        serve_traces = 0
        if traced:
            hops = {}
            for s in trace_spans()[spans0:]:
                if s["kind"] == "serve":
                    hops.setdefault(s["trace"], []).append(s["hop"])
            serve_traces = len(hops)
            if serve_traces != LANES * steps or any(
                    sorted(h) != ["dispatch", "queue"] for h in hops.values()):
                raise AssertionError(f"{serve_traces} serve traces for {LANES * steps} "
                                     f"requests, hops {set(map(tuple, hops.values()))}")
        if steps <= venv.envs[0].horizon:  # no episode ends
            return {"dispatches": dispatches, "checked": checked, "launches": counts[0],
                    "wall": wall, "requests": LANES * steps,
                    "serve_traces": serve_traces}
        deadline = time.monotonic() + 60
        while len(shipped) < LANES and time.monotonic() < deadline:
            time.sleep(0.05)
        lanes = sorted(agent_id for agent_id, _ in shipped)
        if lanes != sorted(mux._sids):
            raise AssertionError(f"episodes shipped by {lanes[:4]}... ({len(lanes)})")
        # What each lane received through the wave replies and shipped:
        # its record j is its session's step j + 1, served by the row the
        # dispatch log holds for that session and step, bit for bit.
        served = log.served_rows()
        compared = 0
        for sid, payload in shipped:
            records = deserialize_actions(payload)
            if len(records) != venv.envs[0].horizon + 1 or not records[-1].done:
                raise AssertionError(f"shipped episode of {len(records)} records")
            for j, rec in enumerate(records[:-1]):
                act, logp_a, v = served[(sid, j + 1)]
                got = (np.asarray(rec.act, act.dtype), np.asarray(rec.data["logp_a"],
                       logp_a.dtype), np.asarray(rec.data["v"], v.dtype))
                if any(g.tobytes() != w.tobytes() for g, w in zip(got, (act, logp_a, v))):
                    raise AssertionError(f"lane {sid} step {j + 1} shipped {got}, the "
                                         f"dispatch served {(act, logp_a, v)}")
                compared += 1
        draw = time_keyed_draws(device, LANES, int(venv.envs[0].action_space.n))
        print(f"[serving] device ms per dispatch of the keyed window step at bucket "
              f"{LANES} (noise draw, copies, forward):", flush=True)
        dev = profile_device(lambda: keyed(full["params"], keys, windows, ts, masks), 10,
                             "dispatch")
        return {"dispatches": dispatches, "checked": checked, "launches": counts[0],
                "occupancy": dict(sorted(collections.Counter(e["rows"] for e in entries).items())),
                "buckets": dict(sorted(collections.Counter(e["bucket"] for e in entries).items())),
                "wall": wall, "requests": LANES * steps, "compared": compared,
                "step_ms": 1e3 * sum(log.step_s) / len(log.step_s), "cross": cross,
                "draw": draw,
                "device_ms": None if dev is None else dev["busy_ms"],
                "inflight": mux.inflight_high_water, "episodes": len(shipped)}
    finally:
        if mux is not None:
            mux.disable_agent()
        svc.stop()
        sink.stop()


def served_learner(device, workdir: Path, per_dispatch: int) -> dict:
    """Phase 18 (b): phase 11's learner in a TrainingServer(serving=True)
    on the card, fed by SERVE_CLIENTS thin clients over ZMQ, one wave of
    RecallEnv(LEARNER_HORIZON) episodes per update. Between waves nothing
    is served, so each update's launches are counted alone (336/4/4); each
    wave's dispatches are all at the version published before it; the
    clients reach the last publish; the ingest accounting is exact."""
    import threading

    import numpy as np

    from relayrl_tpu_torch.envs import RecallEnv
    from relayrl_tpu_torch.runtime.inference import RemoteActorClient
    from relayrl_tpu_torch.runtime.server import TrainingServer

    arch = SLICE_ARCH
    env = RecallEnv(LEARNER_HORIZON, N_CUES)
    hyperparams = {"model_kind": arch["kind"], "seed": SEED, "seed_salt": 0,
                   **{k: v for k, v in arch.items()
                      if k not in ("kind", "has_critic", "precision")},
                   **LEARNER}
    config = serving_config(workdir, learner={"precision": arch["precision"]},
                            serving={"enabled": True, "max_batch": SERVE_CLIENTS,
                                     "batch_timeout_ms": 2.0})
    server_addrs, agent_addrs = zmq_addrs()
    serving_addr = f"tcp://127.0.0.1:{_free_port()}"
    n_layers = arch["n_layers"]
    per_update = (n_layers * (4 + LEARNER["train_vf_iters"]), n_layers, n_layers)
    server = TrainingServer("REINFORCE", obs_dim=int(env.observation_space.shape[0]),
                            act_dim=int(env.action_space.n), env_dir=str(workdir),
                            config_path=config, hyperparams=hyperparams, device=device,
                            serving_addr=serving_addr, **server_addrs)
    svc = server.inference
    clients = []
    try:
        clients = [RemoteActorClient(config_path=config, seed=SEED + i, identity=f"thin-{i}",
                                     probe=False, serving_addr=serving_addr, **agent_addrs)
                   for i in range(SERVE_CLIENTS)]
        envs = [RecallEnv(LEARNER_HORIZON, N_CUES) for _ in clients]
        log = DispatchLog(svc)
        updates, serve_counts, wave_versions, walls = [], [], [], []
        for wave in range(DIST_UPDATES):
            ends, errors = [None] * len(clients), []

            def play(i):
                try:
                    obs, _ = envs[i].reset(seed=SEED + 100 * wave + i)
                    reward, term, trunc = 0.0, False, False
                    for _ in range(LEARNER_HORIZON):
                        rec = clients[i].request_for_action(obs, reward=reward)
                        obs, reward, term, trunc, _ = envs[i].step(int(rec.act))
                        if term or trunc:
                            break
                    ends[i] = (float(reward), bool(term), obs)
                except Exception as e:  # reported on the main thread
                    errors.append(repr(e))

            zero_flash_counts()
            threads = [threading.Thread(target=play, args=(i,)) for i in range(len(clients))]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=DIST_TIMEOUT_S)
            walls.append(time.perf_counter() - t0)
            if errors or any(t.is_alive() for t in threads):
                raise AssertionError(f"wave {wave}: thin clients failed: {errors}")
            served = flash_counts()
            dispatches = len(log.entries)
            if served != (dispatches * per_dispatch, 0, 0):
                raise AssertionError(f"wave {wave}: served launches {served} over "
                                     f"{dispatches} dispatches")
            serve_counts.append(served[0])
            wave_versions.append(sorted({e["version"] for e in log.entries}))
            if wave_versions[-1] != [wave]:
                raise AssertionError(f"wave {wave} served at versions {wave_versions[-1]}")
            log.entries.clear()
            zero_flash_counts()
            for client, (reward, term, obs) in zip(clients, ends):
                client.flag_last_action(reward, truncated=not term,
                                        final_obs=None if term else obs, terminated=term)
            deadline = time.monotonic() + DIST_TIMEOUT_S
            while time.monotonic() < deadline and not (
                    server.stats["updates"] == wave + 1 and svc.version == wave + 1):
                time.sleep(0.02)
            if not server.drain(timeout=60) or svc.version != wave + 1:
                raise AssertionError(f"wave {wave}: update not published and installed "
                                     f"(updates {server.stats['updates']}, served "
                                     f"version {svc.version})")
            updates.append(flash_counts())
            if updates[-1] != per_update:
                raise AssertionError(f"update {wave + 1}: launches {updates[-1]}, "
                                     f"expected {per_update}")
        log.close()
        # One more request each: every client reaches the last publish.
        for client, e in zip(clients, envs):
            client.request_for_action(e.reset(seed=SEED)[0])
        versions = [c.model_version for c in clients]
        if versions != [DIST_UPDATES] * len(clients) or server.algorithm.version != DIST_UPDATES:
            raise AssertionError(f"client versions {versions}, learner "
                                 f"{server.algorithm.version}")
        acct = server.ingest_accounting()["agents"]
        for client in clients:
            sent = client.spool.sent_counts()
            for agent_id, n in sent.items():
                if acct.get(agent_id) != {"max_seq": n, "accepted": n, "contiguous": True} \
                        or n != DIST_UPDATES:
                    raise AssertionError(f"ingest accounting of {agent_id}: "
                                         f"{acct.get(agent_id)}, sent {n}")
        stats = server.stats
        if stats["learner_errors"] or stats["dropped"] or stats["publish_errors"]:
            raise AssertionError(f"server stats {stats}: {server.last_learner_error}")
        return {"updates": updates, "per_update": per_update, "serve_counts": serve_counts,
                "wave_versions": wave_versions, "versions": versions,
                "wave_s": walls, "steps": LEARNER_HORIZON * len(clients),
                "launches": tuple(int(np.sum([u[i] for u in updates])) for i in range(3))}
    finally:
        for client in clients:
            client.disable_agent()
        server.disable_server()


def served_grpc(device, workdir: Path) -> dict:
    """Phase 18 (c): a RemoteActorClient over gRPC GetActions (in-band on
    the pure-grpcio server) against a served mlp_discrete on the card: each
    served action equals the keyed step driven locally on the card, one
    request at a time, bit for bit; no flash kernel launches."""
    import numpy as np

    from relayrl_tpu_torch.envs import make
    from relayrl_tpu_torch.runtime.inference import RemoteActorClient, prng_key
    from relayrl_tpu_torch.runtime.policy_actor import make_keyed_batched_step
    from relayrl_tpu_torch.runtime.server import TrainingServer

    config = serving_config(workdir, serving={"enabled": True, "max_batch": 1,
                                              "batch_timeout_ms": 1.0})
    bind = f"127.0.0.1:{_free_port()}"
    server = TrainingServer("REINFORCE", obs_dim=4, act_dim=2, env_dir=str(workdir),
                            config_path=config, server_type="grpc", native_grpc=False,
                            bind_addr=bind, device=device,
                            hyperparams={**CARTPOLE_HP, "traj_per_epoch": 10_000})
    client = None
    try:
        if server.transport.on_infer is None:
            raise AssertionError("GetActions not installed on the grpcio server")
        svc = server.inference
        client = RemoteActorClient(config_path=config, server_type="grpc", seed=SEED,
                                   probe=False, server_addr=bind)
        local = make_keyed_batched_step(svc.policy)
        params = svc.policy.load_params(server.algorithm.bundle().params)
        key = prng_key(SEED)
        env = make("CartPole-v1")
        obs, _ = env.reset(seed=SEED)
        log = DispatchLog(svc)
        zero_flash_counts()
        t0 = time.perf_counter()
        for _ in range(SERVE_GRPC_STEPS):
            rec = client.request_for_action(obs)
            acts, aux, keys = local(params, key[None], np.asarray(obs, np.float32)[None],
                                    None, svc._explore_kwargs)
            key = keys[0]
            if (np.asarray(rec.act).tobytes() != acts[0].tobytes()
                    or any(rec.data[k].tobytes() != aux[k][0].tobytes() for k in aux)
                    or client._rng.tobytes() != key.tobytes()):
                raise AssertionError(f"gRPC served {rec.act}, {rec.data} != local "
                                     f"{acts[0]}, {aux}")
            obs, _, term, trunc, _ = env.step(int(rec.act))
            if term or trunc:
                client.flag_last_action(0.0, terminated=term)
                obs, _ = env.reset()
        wall = time.perf_counter() - t0
        log.close()
        if flash_counts() != (0, 0, 0) or len(log.entries) < SERVE_GRPC_STEPS:
            raise AssertionError(f"flash launches {flash_counts()}, {len(log.entries)} "
                                 f"dispatches for {SERVE_GRPC_STEPS} requests")
        return {"steps": SERVE_GRPC_STEPS, "wall": wall, "version": client.model_version}
    finally:
        if client is not None:
            client.disable_agent()
        server.disable_server()


def _tree_leaves(tree, prefix: str = ""):
    """``(path, array)`` of every leaf of a flax params tree."""
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            yield from _tree_leaves(value, path)
        else:
            yield path, value


def rm_planes(rm, episodes: list, device) -> dict:
    """The reward model's scores of ``episodes`` ((tokens, gen_len) pairs,
    8 of them) one at a time and as a batch of 8: through the raw forward
    (a 1-row and an 8-row matrix product, as a library picks kernels for
    them; not gated) and through the scorer's planes (``score_np`` and
    ``score_batch_np``, every dispatch ``batch_rows`` rows; must be bit-equal)."""
    import numpy as np
    import torch

    prompt = RLHF["prompt_len"]
    tokens = np.stack([t for t, _ in episodes])
    gen_lens = np.asarray([g for _, g in episodes], np.int32)
    tok = torch.as_tensor(tokens, device=device).long()
    read = torch.as_tensor(gen_lens + prompt - 1, device=device).long()
    batch = rm._forward(tok, read)
    single = torch.cat([rm._forward(tok[i:i + 1], read[i:i + 1]) for i in range(len(tok))])
    planes_batch = rm.score_batch_np(tokens, prompt, gen_lens)
    planes_single = np.asarray([rm.score_np(t, prompt, g) for t, g in episodes], np.float32)
    if planes_single.tobytes() != planes_batch.tobytes():
        raise AssertionError(f"reward model planes differ: one at a time {planes_single}, "
                             f"batched {planes_batch}")
    return {"raw_diff": (batch - single).abs().max().item(),
            "raw_equal": torch.equal(batch, single), "rows": len(episodes)}


def rlhf_plane(device, workdir: Path, tier: str, per_dispatch: int,
               updates: int | None = None, traced: bool = False) -> dict:
    """Phase 19: the RlhfScheduler on generation tier ``tier`` ("vector",
    "anakin" with the window captured as one CUDA graph, or "remote" thin
    clients of a ``TrainingServer(serving=True)``) against an in-process
    ``TrainingServer("IMPALA")`` on the card at the flagship's widths, the
    lower half frozen (``RLHF_FREEZE``), the reward model scoring, for
    ``RLHF_UPDATES[tier]`` updates. Gates: every episode that reaches the
    server carries a terminal reward equal to the reward model's score of
    its tokens, re-scored here from the emitted bytes; every record's
    ``bver`` lies between 0 and the version the host held at emission;
    ``accepted == max_seq == sent`` per lane, contiguous; the frozen leaves
    bit-identical after the updates and the others moved; the server's
    train-lag histogram observed once per trajectory; K1 = the generation's
    dispatches (or the graph's replays) x their K1 + the updates' 4 each,
    K2 and K3 4 per update (the freeze is the optimizer's: the backward
    still runs block 0). On the vector tier also :func:`rm_planes` on the
    first 8 episodes. ``updates`` overrides ``RLHF_UPDATES[tier]``;
    ``traced`` (phase 20, the process tracer live) adds the stage spans'
    gates: the ``generate`` spans' episodes sum to the generation's, the
    ``score`` and ``emit`` spans' to the episodes shipped, and every
    shipped episode has a complete upstream trace whose ``env`` hop starts
    at its window's production stamp; on the anakin tier the graph still
    equals the eager window."""
    import numpy as np
    import torch

    from relayrl_tpu_torch import telemetry
    from relayrl_tpu_torch.rlhf.scheduler import (
        RlhfScheduler,
        extract_generation,
        extract_generation_frame,
    )
    from relayrl_tpu_torch.runtime.server import TrainingServer
    from relayrl_tpu_torch.types.columnar import is_columnar_frame, parse_frame
    from relayrl_tpu_torch.types.trajectory import deserialize_actions

    arch, prompt = SLICE_ARCH, RLHF["prompt_len"]
    updates_wanted = RLHF_UPDATES[tier] if updates is None else updates
    context = prompt + RLHF["max_new_tokens"]
    per_epoch = IMPALA_HP["traj_per_epoch"]
    n_layers = arch["n_layers"]
    hyperparams = {"model_kind": arch["kind"], "seed": SEED, "seed_salt": 0,
                   **{k: v for k, v in arch.items()
                      if k not in ("kind", "has_critic", "precision")},
                   **IMPALA_HP}
    sections = {"max_traj_length": context,
                "learner": {"precision": arch["precision"], "freeze": RLHF_FREEZE},
                "rlhf": {**RLHF, "generation_tier": tier}}
    server_addrs, agent_addrs = zmq_addrs()
    if tier == "remote":
        serving_addr = f"tcp://127.0.0.1:{_free_port()}"
        sections["serving"] = {"enabled": True, "max_batch": RLHF["lanes"],
                               "batch_timeout_ms": 2.0, "max_sessions": 2 * RLHF["lanes"]}
        server_addrs["serving_addr"] = serving_addr
        agent_addrs = {**agent_addrs, "serving_addr": serving_addr, "probe": False}
    config = serving_config(workdir, **sections)
    telemetry.set_registry(telemetry.Registry(run_id=f"chip-smoke-rlhf-{tier}"))
    server = TrainingServer("IMPALA", obs_dim=context, act_dim=RLHF["vocab_size"],
                            env_dir=str(workdir), config_path=config,
                            hyperparams=hyperparams, device=device, **server_addrs)
    before = dict(_tree_leaves(server.algorithm.bundle().params))
    svc, sched = server.inference, None
    served = [0]
    try:
        sched = RlhfScheduler(config_path=config, seed=SEED, identity=f"rlhf-{tier}",
                              device=device, **agent_addrs)
        host, rm = sched.generation.host, sched.scorer
        shipped = []
        emit = sched.score_stage.emit_fn

        def keep(lane, payload, *stamps):
            shipped.append((payload, host.version))
            emit(lane, payload, *stamps)

        sched.score_stage.emit_fn = keep
        if svc is not None:
            window_fn = svc._window_fn

            def counted(*args):
                served[0] += 1
                return window_fn(*args)

            svc._window_fn = counted
        torch.cuda.synchronize()
        zero_flash_counts()
        replays0 = getattr(host, "replays", 0)
        spans0 = len(trace_spans())
        t0 = time.perf_counter()
        stats = sched.run(episodes=updates_wanted * per_epoch, deadline_s=RLHF_TIMEOUT_S)
        wall = time.perf_counter() - t0
        sched.flush()
        deadline = time.monotonic() + RLHF_TIMEOUT_S
        while (server.stats["trajectories"] < len(shipped)
               and time.monotonic() < deadline):
            time.sleep(0.02)
        if not server.drain(timeout=60):
            raise AssertionError(f"{tier}: the server did not drain")
        torch.cuda.synchronize()
        counts = flash_counts()
        updates = server.stats["updates"]
        if (stats["episodes_scored"] < updates_wanted * per_epoch
                or server.stats["trajectories"] != len(shipped)
                or updates != len(shipped) // per_epoch or updates < updates_wanted):
            raise AssertionError(f"{tier}: {stats['episodes_scored']} scored, {len(shipped)} "
                                 f"shipped, server {server.stats}")
        if server.stats["learner_errors"] or server.stats["dropped"]:
            raise AssertionError(f"{tier}: server {server.stats}: {server.last_learner_error}")

        # Scores and bver, from the emitted bytes.
        episodes, gen_lens = [], []
        for payload, held in shipped:
            if is_columnar_frame(payload):
                dt = parse_frame(payload)
                tokens, gen_len = extract_generation_frame(dt, prompt)
                reward = dt.columns["r"][-1]
                bvers = np.asarray(dt.aux["bver"]).reshape(-1).tolist()
            else:
                records = deserialize_actions(payload)
                tokens, gen_len, marker = extract_generation(records, prompt)
                reward = marker.rew
                bvers = [int(r.data["bver"]) for r in records if r.act is not None]
            want = np.float32(rm.score_np(tokens, prompt, gen_len))
            if np.float32(reward) != want:
                raise AssertionError(f"{tier}: shipped reward {reward} != the reward model's "
                                     f"{want} on the shipped tokens")
            if len(bvers) != gen_len or not all(0 <= b <= held for b in bvers):
                raise AssertionError(f"{tier}: bver {bvers} for {gen_len} tokens, held {held}")
            episodes.append((tokens, gen_len))
            gen_lens.append(gen_len)

        # Ingest accounting.
        acct = server.ingest_accounting()["agents"]
        sent = (sched.agent.spool.sent_counts() if sched.agent is not None else
                {k: n for c in sched._clients for k, n in c.spool.sent_counts().items()})
        if sum(sent.values()) != len(shipped) or set(acct) != {k for k, n in sent.items() if n}:
            raise AssertionError(f"{tier}: sent {sent}, accounted {sorted(acct)}")
        for agent_id, row in acct.items():
            n = sent[agent_id]
            if row != {"max_seq": n, "accepted": n, "contiguous": True}:
                raise AssertionError(f"{tier}: ingest accounting of {agent_id}: {row}, sent {n}")

        # The freeze.
        after = dict(_tree_leaves(server.algorithm.bundle().params))
        frozen = [p for p in before if p.startswith(RLHF_FROZEN)]
        moved = [p for p in before if not p.startswith(RLHF_FROZEN)
                 and not np.array_equal(before[p], after[p])]
        if len(frozen) < 8 or any(not np.array_equal(before[p], after[p]) for p in frozen) \
                or not moved:
            raise AssertionError(f"{tier}: frozen leaves {frozen} changed or none of the "
                                 f"others moved ({moved})")

        # The lag histogram and the metric family.
        lag_counts, lag_sum, lag_n = server._m_rlhf_train_lag.totals()
        if lag_n != len(shipped):
            raise AssertionError(f"{tier}: train-lag histogram observed {lag_n} of "
                                 f"{len(shipped)} trajectories")
        names = {m["name"] for m in telemetry.get_registry().snapshot()["metrics"]}
        missing = {"relayrl_rlhf_generated_tokens_total", "relayrl_rlhf_scored_episodes_total",
                   "relayrl_rlhf_stage_seconds", "relayrl_rlhf_lag_versions",
                   "relayrl_rlhf_train_lag_versions"} - names
        if missing:
            raise AssertionError(f"{tier}: metrics missing {missing}")

        # Kernel launches.
        learner = n_layers * updates
        if tier == "anakin":
            per_window = (n_layers - 1) * RLHF["generation_unroll"]
            if host.captured_launches != (per_window, 0, 0, 0, 0, 0):
                raise AssertionError(f"anakin: captured {host.captured_launches}")
            generation, dispatches = per_window * (host.replays - replays0), host.replays - replays0
            counted_k1 = learner
        else:
            dispatches = served[0] if tier == "remote" else sched.generation.rounds
            generation = per_dispatch * dispatches
            counted_k1 = generation + learner
        if counts != (counted_k1, learner, learner):
            raise AssertionError(f"{tier}: launches {counts}, expected ({counted_k1}, "
                                 f"{learner}, {learner}) for {dispatches} generation "
                                 f"dispatches and {updates} updates")
        score_counts, score_sum, score_n = sched.score_stage._m_score_s.totals()
        out = {"updates": updates, "episodes": len(shipped), "dispatches": dispatches,
               "launches": (generation + learner, learner, learner),
               "generation_k1": generation, "learner_k1": learner,
               "tokens": stats["tokens_generated"], "wall": wall,
               "score_ms": 1e3 * score_sum / max(1, score_n), "score_batches": score_n,
               "scores": stats["scores"], "gen_lens": (min(gen_lens), max(gen_lens)),
               "lag": (lag_sum / max(1, lag_n)), "frozen": len(frozen), "moved": len(moved)}
        if tier == "vector":
            out["planes"] = rm_planes(rm, episodes[:8], device)
        if traced:
            out.update(rlhf_spans(trace_spans()[spans0:], f"rlhf-{tier}", len(shipped),
                                  updates * per_epoch, sched.generation.episodes_done,
                                  dispatches if tier == "anakin" else None))
            if tier == "anakin":
                differs = graph_vs_eager(host)
                if differs:
                    raise AssertionError(f"anakin, traced: graph != eager in {differs}")
        return out
    finally:
        if sched is not None:
            sched.close()
        server.disable_server()


def trace_spans() -> list[dict]:
    """This process's live trace ring (empty under the null tracer)."""
    from relayrl_tpu_torch.telemetry import trace as trace_mod

    return trace_mod.snapshot_spans()


def admitted_hops(spans: list[dict]) -> dict[str, dict]:
    """Trajectory trace id -> {hop: span}. Of the server's ingest and
    dedup spans it keeps the arrival the dedup ledger admitted: a
    redelivery (a spool's replay) records an ingest and an admitted-false
    dedup of its own."""
    traj: dict[str, dict] = {}
    arrivals: dict[str, list] = {}
    for s in spans:
        if s["kind"] != "traj":
            continue
        if s["hop"] in ("ingest", "dedup"):
            arrivals.setdefault(s["trace"], []).append(s)
        elif s["hop"] in traj.setdefault(s["trace"], {}):
            raise AssertionError(f"two {s['hop']} spans in trace {s['trace']}")
        else:
            traj[s["trace"]][s["hop"]] = s
    for tid, ss in arrivals.items():
        ingests = sorted((s for s in ss if s["hop"] == "ingest"), key=lambda s: s["t0_ns"])
        dedups = sorted((s for s in ss if s["hop"] == "dedup"), key=lambda s: s["t0_ns"])
        kept = [(i, d) for i, d in zip(ingests, dedups) if d["admitted"]]
        if len(ingests) != len(dedups) or len(kept) != 1:
            raise AssertionError(f"trace {tid}: {len(ingests)} ingest(s), {len(dedups)} "
                                 f"dedup(s), {len(kept)} admitted")
        traj.setdefault(tid, {}).update(ingest=kept[0][0], dedup=kept[0][1])
    return traj


def check_upstream(traj: dict[str, dict], hops_wanted: tuple) -> None:
    """Every trace holds exactly ``hops_wanted``, hop starts in causal
    order, and no two hops overlap inside the actor's chain (env, encode,
    send) or the server's (ingest, dedup, staging, update); its data age
    lies in [0, 300 s)."""
    from relayrl_tpu_torch.telemetry.trace import SKEW_GUARD_NS

    for tid, hops in traj.items():
        if set(hops) != set(hops_wanted):
            raise AssertionError(f"trace {tid}: hops {sorted(hops)}, want {hops_wanted}")
        starts = [hops[h]["t0_ns"] for h in hops_wanted]
        if starts != sorted(starts):
            raise AssertionError(f"trace {tid}: hop starts out of order {starts}")
        for chain in (("env", "encode", "send"), ("ingest", "dedup", "staging", "update")):
            if any(hops[a]["t1_ns"] > hops[b]["t0_ns"] for a, b in zip(chain, chain[1:])):
                raise AssertionError(f"trace {tid}: overlapping hops in {chain}")
        age = hops["update"]["t1_ns"] - hops["env"]["t0_ns"]
        if not 0 <= age < SKEW_GUARD_NS:
            raise AssertionError(f"trace {tid}: data age {age} ns")


def rlhf_spans(spans: list[dict], identity: str, shipped: int, consumed: int,
               generated: int, windows: int | None) -> dict:
    """Phase 20's RLHF gates on one run's spans: the ``generate`` spans'
    episodes sum to the rounds' completed generations, the ``score`` and
    ``emit`` spans' to the episodes shipped; every shipped episode of
    ``identity``'s lanes is traced, the ``consumed`` ones that an update
    trained on env to update (no relay), the rest (still in the learner's
    epoch buffer) up to staging; with ``windows`` (the anakin tier's
    replays) their ``env`` hops start at no more distinct stamps than
    windows were produced."""
    sums = {hop: sum(s.get("episodes", 0) for s in spans
                     if s["kind"] == "rlhf" and s["hop"] == hop)
            for hop in ("generate", "score", "emit")}
    if sums != {"generate": generated, "score": shipped, "emit": shipped}:
        raise AssertionError(f"rlhf spans' episodes {sums}: generated {generated}, "
                             f"shipped {shipped}")
    traj = admitted_hops(spans)
    mine = {tid: hops for tid, hops in traj.items()
            if hops.get("env", {}).get("agent", "").startswith(identity)}
    trained = {tid: hops for tid, hops in mine.items() if "update" in hops}
    if len(mine) != shipped or len(trained) != consumed:
        raise AssertionError(f"{len(mine)} traced episodes of {shipped} shipped, "
                             f"{len(trained)} of {consumed} through an update")
    hops_wanted = tuple(h for h in UPSTREAM_HOPS if h != "relay")
    check_upstream(trained, hops_wanted)
    for tid, hops in mine.items():
        if tid not in trained and set(hops) != set(hops_wanted[:-1]):
            raise AssertionError(f"untrained trace {tid}: hops {sorted(hops)}")
    born = {hops["env"]["t0_ns"] for hops in mine.values()}
    if windows is not None and not 1 <= len(born) <= windows:
        raise AssertionError(f"{len(born)} distinct env stamps over {windows} windows")
    return {"rlhf_spans": sums, "rlhf_traces": len(mine), "rlhf_stamps": len(born)}


def _counter_rows(snapshot: dict) -> dict:
    return {(m["name"], tuple(sorted((m.get("labels") or {}).items()))): m["value"]
            for m in snapshot["metrics"] if m["kind"] == "counter"}


def _fleet_self(key) -> bool:
    name, labels = key
    return (name.startswith(FLEET_SELF_PREFIX) or name in FLEET_SELF_COUNTERS
            or dict(labels).get("plane") == "fleet")


def traced_fleet(device, root: Path, workdir: Path) -> dict:
    """Phase 20 (a): phase 11's learner in a ``chaos_server`` process with
    tracing at rate 1 and the fleet plane on (``fleet_interval_s``
    ``FLEET_INTERVAL_S``, an exporter on a free port, an events journal),
    behind a ``python -m relayrl_tpu_torch.relay`` process (ZMQ both
    sides, the same telemetry), fed by a traced ``VectorAgent`` of
    ``DIST_LANES`` ``RecallEnv(LEARNER_HORIZON)`` lanes in this process
    with its fleet emitter on, for ``TRACED_UPDATES`` updates (each wave
    played under the version the previous one published). Gates: every
    accepted trajectory's upstream trace complete over ``UPSTREAM_HOPS``
    (monotonic starts, no overlap inside a plane); every published
    version's model trace over ``MODEL_HOPS``; every data and model age
    in [0, 300 s), one observation per trace in each process that saw it;
    the trace analyzer CLI over the three journals agreeing with this
    process's analysis, its data-age count the accepted count; the
    trace-side mean version lag within 0.5 of the server's
    ``relayrl_rlhf_train_lag_versions``; ``/fleet`` listing the three
    processes, ``top --fleet`` rendering the pane, no default alert
    active; the root's merged counters (bar the fleet frames' own,
    ``FLEET_SELF_COUNTERS``) equal to the sum of the three processes'
    final registries exactly, env steps those the agent took; 336/4/4
    launches per update and 3 K1 per dispatch; the agent's params equal
    to the publish."""
    import os
    import shutil
    import urllib.request

    from relayrl_tpu_torch import telemetry
    from relayrl_tpu_torch.envs import RecallEnv, SyncVectorEnv
    from relayrl_tpu_torch.runtime.agent import VectorAgent
    from relayrl_tpu_torch.runtime.vector_actor import run_vector_gym_loop
    from relayrl_tpu_torch.telemetry import trace as trace_mod
    from relayrl_tpu_torch.telemetry.events import EventJournal
    from relayrl_tpu_torch.weights import params_to_jax, tree_digest

    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    journals = {p: workdir / f"{p}_events.ndjson" for p in ("server", "relay", "agent")}
    tel = {"trace_sample_rate": 1.0, "fleet_interval_s": FLEET_INTERVAL_S}
    server_addrs, relay_up = zmq_addrs()
    relay_down, agent_addrs = zmq_addrs()
    env = RecallEnv(LEARNER_HORIZON, N_CUES)
    arch = SLICE_ARCH
    hyperparams = {"model_kind": arch["kind"], "seed": SEED, "seed_salt": 0,
                   **{k: v for k, v in arch.items()
                      if k not in ("kind", "has_critic", "precision")},
                   **LEARNER}
    cfg = {"algorithm": "REINFORCE",
           "obs_dim": int(env.observation_space.shape[0]),
           "act_dim": int(env.action_space.n), "hyperparams": hyperparams,
           "device": str(device), "scratch": str(workdir / "server"),
           "config": {"learner": {"precision": arch["precision"]},
                      "telemetry": {**tel, "port": 0,
                                    "events_path": str(journals["server"])}},
           "digests": True, "status_path": str(workdir / "status.json"),
           "stop_path": str(workdir / "server_stop"), **server_addrs}
    relay_config = workdir / "relay_config.json"
    relay_config.write_text(json.dumps({"telemetry": {
        **tel, "enabled": True, "events_path": str(journals["relay"])}}))
    agent_config = workdir / "agent_config.json"
    agent_config.write_text(json.dumps({"telemetry": tel}))
    # This process configured its telemetry long ago with the plane off:
    # install a live registry, a journal and the tracer before the agent.
    run_id = "chip-smoke-traced-agent"
    telemetry.set_registry(telemetry.Registry(run_id=run_id))
    telemetry.set_journal(EventJournal(str(journals["agent"]), run_id=run_id))
    trace_mod.configure(1.0, ring=1 << 16)
    n_layers = arch["n_layers"]
    per_update = (n_layers * (4 + LEARNER["train_vf_iters"]), n_layers, n_layers)

    server = ChaosServer(root, cfg, workdir / "server.log")
    relay = agent = None
    try:
        server.wait(lambda s: s.get("exporter") is not None, "the server to come up")
        relay = RelayProcess(root, {"config_path": str(relay_config), "name": "p20-relay",
                                    "upstream_type": "zmq",
                                    "upstream": {**relay_up, "probe": False},
                                    "downstream_type": "zmq", "downstream": relay_down},
                             workdir, "traced", flags=("--no-telemetry",))
        agent = VectorAgent(num_envs=DIST_LANES, config_path=str(agent_config), seed=SEED,
                            identity="p20-agent", probe=False, device=device,
                            model_path=str(workdir / "client_model.rlx"), **agent_addrs)
        venv = SyncVectorEnv([lambda: RecallEnv(LEARNER_HORIZON, N_CUES)] * DIST_LANES)
        zero_flash_counts()
        dispatches0, wall = agent.host.dispatches, 0.0
        for version in range(1, TRACED_UPDATES + 1):
            t0 = time.perf_counter()
            run_vector_gym_loop(agent, venv, LEARNER_HORIZON, seed=SEED + version)
            wall += time.perf_counter() - t0
            status = server.wait(
                lambda s, v=version: (s["version"] == v and agent.model_version == v
                                      and (s.get("published") or {}).get("version") == v),
                f"version {version} published and installed")
        dispatches = agent.host.dispatches - dispatches0
        agent_counts = flash_counts()
        steps = agent.host.steps_served
        with agent.host._lock:
            agent_version = agent.host.version
            agent_digest = tree_digest(params_to_jax(agent.host.params))
        stats = status["stats"]
        if stats["learner_errors"] or stats["dropped"] or stats["publish_errors"]:
            raise AssertionError(f"server stats {stats}: {status['last_learner_error']}")
        kernels = status["kernels"]
        server_counts = (kernels["flash_fwd"], kernels["flash_dq"], kernels["flash_dkv"])
        if server_counts != tuple(TRACED_UPDATES * c for c in per_update):
            raise AssertionError(f"server launches {server_counts} over {TRACED_UPDATES} "
                                 f"updates; expected {TRACED_UPDATES} x {per_update}")
        if agent_counts != ((n_layers - 1) * dispatches, 0, 0):
            raise AssertionError(f"agent launches {agent_counts} over {dispatches} "
                                 f"dispatches")
        published = status["published"]
        if (agent_version, agent_digest) != (published["version"], published["digest"]):
            raise AssertionError(f"agent params at version {agent_version} "
                                 f"({agent_digest}) != published {published}")

        # Idle a few intervals, so every process's frames carry its settled
        # totals, then read the root's pane while all three are up.
        time.sleep(3 * FLEET_INTERVAL_S)
        url = status["exporter"]
        with urllib.request.urlopen(url + "/fleet", timeout=10) as resp:
            live = json.loads(resp.read().decode())
        procs = {p["proc"]: p["tier"] for p in live["procs"]}
        want_procs = {"p20-agent": "actor", "p20-relay": "relay",
                      f"server-{server.proc.pid}": "server"}
        if procs != want_procs:
            raise AssertionError(f"/fleet lists {procs}, want {want_procs}")
        top = subprocess.run(
            [sys.executable, "-m", "relayrl_tpu_torch.telemetry.top", "--url", url,
             "--fleet", "--once"], cwd=str(root), capture_output=True, text=True,
            timeout=60, env=dict(os.environ, PYTHONPATH=str(root)))
        if top.returncode or "3 proc(s)" not in top.stdout or "-- relay " not in top.stdout:
            raise AssertionError(f"top --fleet: rc {top.returncode}\n{top.stdout}\n"
                                 f"{top.stderr[-2000:]}")

        # Leaf first: the agent's closing frame, the relay's, the root's
        # closing tick and final status.
        agent.disable_agent()
        agent_final = telemetry.get_registry().snapshot()
        agent = None
        relay_result = relay.close()
        relay = None
        Path(cfg["stop_path"]).write_text("stop")
        server.proc.wait(timeout=120)
        final = server.status()
        if final is None or not final.get("final"):
            raise AssertionError(f"no final status:\n{server.tail()}")
    finally:
        if agent is not None:
            agent.disable_agent()
        if relay is not None:
            relay.kill()
        server.stop()

    # The traces, joined over the three processes' journals.
    spans = trace_mod.load_spans([str(p) for p in journals.values()])
    accepted = final["stats"]["trajectories"]
    traj = admitted_hops(spans)
    if len(traj) != accepted or accepted != TRACED_UPDATES * LEARNER["traj_per_epoch"]:
        raise AssertionError(f"{len(traj)} traced trajectories, {accepted} accepted")
    check_upstream(traj, UPSTREAM_HOPS)
    model: dict[str, list] = {}
    for s in spans:
        if s["kind"] == "model":
            model.setdefault(s["trace"], []).append(s)
    versions = sorted(int(v) for v in final["published_log"])
    if versions != list(range(1, TRACED_UPDATES + 1)) or sorted(model) != sorted(
            trace_mod.model_trace_id(v) for v in versions):
        raise AssertionError(f"model traces {sorted(model)} for versions {versions}")
    for tid, ss in model.items():
        hops = {s["hop"] for s in ss}
        receipts = sum(s["hop"] == "receipt" for s in ss)
        disp = next(s for s in ss if s["hop"] == "dispatch")
        ages = [s["t1_ns"] - disp["t0_ns"] for s in ss if s["hop"] == "swap"]
        if (hops != set(MODEL_HOPS) or receipts != 2 or len(ages) != 1
                or not 0 <= ages[0] < trace_mod.SKEW_GUARD_NS):
            raise AssertionError(f"model trace {tid}: hops {sorted(hops)}, {receipts} "
                                 f"receipts, swap ages {ages}")
    report = trace_mod.analyze(spans)
    cli = subprocess.run(
        [sys.executable, "-m", "relayrl_tpu_torch.telemetry.trace",
         *[str(p) for p in journals.values()], "--json"], cwd=str(root),
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(root)))
    if cli.returncode or json.loads(cli.stdout) != json.loads(json.dumps(report)):
        raise AssertionError(f"trace CLI rc {cli.returncode}: {cli.stderr[-2000:]}")
    if report["trajectories"]["data_age_s"]["count"] != accepted or report["skew_dropped"]:
        raise AssertionError(f"analyzer: {report['trajectories']}, skew-dropped "
                             f"{report['skew_dropped']}")

    # One age observation per trace in each process that saw it.
    def metric(snapshot, name):
        return next(m for m in snapshot["metrics"] if m["name"] == name)

    server_final, relay_final = final["telemetry"], relay_result["telemetry"]
    observed = (metric(server_final, "relayrl_trace_data_age_seconds")["count"],
                metric(agent_final, "relayrl_trace_model_age_seconds")["count"],
                metric(relay_final, "relayrl_trace_model_age_seconds")["count"])
    if observed != (accepted, len(versions), len(versions)):
        raise AssertionError(f"age observations (data, model at the agent, model at the "
                             f"relay) {observed}; {accepted} trajectories, "
                             f"{len(versions)} versions")
    lag = metric(server_final, "relayrl_rlhf_train_lag_versions")
    trace_lag = report["trajectories"]["data_age_versions"]["mean"]
    if lag["count"] != accepted or abs(trace_lag - lag["sum"] / lag["count"]) > 0.5:
        raise AssertionError(f"trace-side lag {trace_lag} vs the train-lag histogram "
                             f"{lag['sum']} / {lag['count']}")

    # The root's totals against the three processes' own.
    doc = final["fleet"]
    merged = _counter_rows(doc["merged"])
    want: dict = {}
    for snap in (agent_final, relay_final, server_final):
        for key, value in _counter_rows(snap).items():
            want[key] = want.get(key, 0.0) + value
    exact = {k: v for k, v in want.items() if not _fleet_self(k)}
    wrong = {k: (merged.get(k), v) for k, v in exact.items() if merged.get(k) != v}
    behind = {k: (merged.get(k), v) for k, v in want.items()
              if _fleet_self(k) and not (merged.get(k) or 0) <= v}
    env_key = ("relayrl_actor_env_steps_total", ())
    if wrong or behind or merged.get(env_key) != steps:
        raise AssertionError(f"fleet totals: {len(wrong)} counters off the sum "
                             f"{dict(list(wrong.items())[:6])}; self counters ahead "
                             f"{behind}; env steps {merged.get(env_key)} vs {steps}")
    active = [a["name"] for a in doc["alerts"] + live["alerts"] if a["active"]]
    if active:
        raise AssertionError(f"alerts active on a clean run: {active}")
    return {"updates": TRACED_UPDATES, "accepted": accepted, "dispatches": dispatches,
            "server_counts": server_counts, "agent_counts": agent_counts,
            "per_update": per_update, "versions": versions, "report": report,
            "spans": len(spans), "counters_exact": len(exact),
            "counters_self": len(want) - len(exact), "steps": steps,
            "steps_per_s": DIST_LANES * dispatches / wall, "procs": sorted(procs)}


def profiled_update(learned: dict, workdir: Path) -> dict:
    """Phase 20 (c): one REINFORCE update of phase 5's learner inside
    ``utils.profiling.trace`` with ``annotate`` around it. Gates: the
    Chrome trace lists ``flash_fwd_bf16_kernel``, ``flash_dq_bf16_kernel``
    and ``flash_dkv_bf16_kernel`` at the update's launch counts (336/4/4),
    each inside the annotated range."""
    import shutil

    import torch

    from relayrl_tpu_torch.utils import profiling

    shutil.rmtree(workdir, ignore_errors=True)
    algo, batch = learned["algo"], learned["batch"]
    n_layers = SLICE_ARCH["n_layers"]
    per_update = (n_layers * (4 + LEARNER["train_vf_iters"]), n_layers, n_layers)
    torch.cuda.synchronize()
    zero_flash_counts()
    with profiling.trace(str(workdir)) as prof:
        with profiling.annotate("chip_smoke_update"):
            algo.train_on_batch(batch)
            torch.cuda.synchronize()
    counts = flash_counts()
    events = json.loads(Path(prof.trace_path).read_text())["traceEvents"]
    ranges = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("name") == "chip_smoke_update" and e.get("ph") == "X"]
    found = []
    for name in ("flash_fwd_bf16_kernel", "flash_dq_bf16_kernel", "flash_dkv_bf16_kernel"):
        hits = [e for e in events if e.get("cat") == "kernel" and name in e.get("name", "")]
        outside = [e for e in hits if not any(a <= e["ts"] <= b for a, b in ranges)]
        if outside:
            raise AssertionError(f"{len(outside)} {name} launches outside the annotated "
                                 f"range {ranges}")
        found.append(len(hits))
    if counts != per_update or tuple(found) != per_update or not ranges:
        raise AssertionError(f"profiled update: counters {counts}, the trace's kernels "
                             f"{tuple(found)}, expected {per_update}; ranges {ranges}")
    return {"counts": counts, "found": tuple(found), "events": len(events),
            "trace": prof.trace_path, "ranges": len(ranges)}


# -- phase 21: the mesh learner ---------------------------------------------------

def mesh_of(spec: dict, device):
    """A single-controller mesh of ``MESH_SIZE`` entries, every one
    ``device`` (with its index, so a placed tensor's device compares equal
    to its mesh coordinate's)."""
    import torch

    from relayrl_tpu_torch.parallel import make_mesh

    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return make_mesh(spec, [device] * MESH_SIZE)


def on_mesh(mesh):
    """A ``wrap`` for an update: a state not yet placed is placed on
    ``mesh`` (:func:`place_state`), then the update runs through
    ``make_sharded_update``."""
    from relayrl_tpu_torch.parallel import make_sharded_update, place_state
    from relayrl_tpu_torch.weights import is_placed

    def wrap(update):
        def run(state, batch):
            if not is_placed(state.params):
                state = place_state(state, mesh)
            return make_sharded_update(update, mesh, state)(state, batch)
        return run
    return wrap


def one_update(algo, params0, batch, device, wrap=None, plain_attn=None):
    """The first update of ``algo``'s kind from ``params0`` with fresh Adam
    (:func:`update_parts`), through the kernels or with every block's
    attention ``plain_attn``; ``wrap`` wraps the update. Returns
    ``((params by logical name, metrics), state, K1-K3 launches, steps,
    update)``; the launches are the update's alone."""
    import torch

    from relayrl_tpu_torch.algorithms.onpolicy import read_metrics
    from relayrl_tpu_torch.weights import logical_state

    params = copy.deepcopy(params0)
    if plain_attn is not None:
        for block in params.layers():
            block.attn_fn = plain_attn
    state, update, steps = update_parts(algo, algo.policy, params)
    if wrap is not None:
        update = wrap(update)
    zero_flash_counts()
    state, metrics = update(state, {k: torch.as_tensor(v, device=device)
                                    for k, v in batch.items()})
    metrics = read_metrics(metrics)
    torch.cuda.synchronize()
    return (logical_state(state.params), metrics), state, flash_counts(), steps, update


def update_ms(update, state, batch, device, n: int = 1) -> tuple[float, object]:
    """Mean wall ms of ``n`` more updates of ``state`` on ``batch``."""
    import torch

    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        state, _ = update(state, batch)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n, state


def hold_f32(got_side, want_side, what: str) -> dict:
    """A sharded update against its unsharded one at the JAX test's bars
    (``MESH_RTOL``, ``MESH_ATOL``; metrics at ``MESH_METRIC_RTOL``);
    returns the largest differences and whether the two are bit-equal."""
    import torch

    (got, got_m), (want, want_m) = got_side, want_side
    for key, value in want_m.items():
        if not abs(got_m[key] - value) <= MESH_METRIC_RTOL * max(abs(value), 1e-6):
            raise AssertionError(f"{what}: metric {key} {got_m[key]} vs {value}")
    param_err = 0.0
    for name, w in want.items():
        g = got[name]
        if not torch.allclose(g, w, rtol=MESH_RTOL, atol=MESH_ATOL):
            raise AssertionError(f"{what}: {name} max abs diff "
                                 f"{(g - w).abs().max().item()}")
        param_err = max(param_err, (g.float() - w.float()).abs().max().item())
    bit_equal = (all(torch.equal(got[n], want[n]) for n in want)
                 and all(got_m[k] == want_m[k] for k in want_m))
    return {"param_err": param_err, "bit_equal": bit_equal,
            "metric_err": max(abs(got_m[k] - want_m[k]) for k in want_m)}


def mesh_pp(device, workdir: Path, learned: dict) -> dict:
    """Phase 21a: the pp flagship (``transformer_pp_discrete`` at
    ``__graft_entry__.entry()``'s widths) under ``PP_MESH``. The pipelined
    ``evaluate`` on phase 5's first batch against the unpipelined one
    (phase 4's bar) at layers x microbatches x data groups K1; the first
    update through K1-K3 against the same pipelined update through the
    plain attention and against the unpipelined update through the
    kernels (phase 5's bars), at exactly 84 x that many K1 and that many
    K2 and K3; each stage's layers on its device."""
    import torch

    from relayrl_tpu_torch.parallel import resolve_microbatches, use_mesh

    seconds, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    algo = build_learner(device, workdir, PP_ARCH)
    params0 = copy.deepcopy(algo.state.params)
    mesh = mesh_of(PP_MESH, device)
    batch = learned["batch"]
    n_layers, stages, groups = PP_ARCH["n_layers"], PP_MESH["pp"], PP_MESH["dp"]
    micro = resolve_microbatches(LEARNER["traj_per_epoch"] // groups, stages)
    per_pass = n_layers * micro * groups
    obs = torch.as_tensor(batch["obs"], device=device)
    act = torch.as_tensor(batch["act"], device=device)
    zero_flash_counts()
    with torch.inference_mode():
        with use_mesh(mesh):
            got = algo.policy.evaluate(params0, obs, act)
        eval_k1 = flash_counts()[0]
        want = algo.policy.evaluate(params0, obs, act)
    eval_err = max((a - b).abs().max().item() for a, b in zip(got, want))
    lap("evaluate")
    if eval_k1 != per_pass or not eval_err <= TOLERANCE["bfloat16"]:
        raise AssertionError(f"pipelined evaluate: {eval_k1} K1 (expected {per_pass}), "
                             f"max abs diff {eval_err} against the unpipelined one")
    kernel, state, launches, steps, update = one_update(algo, params0, batch, device,
                                                         on_mesh(mesh))
    expected = (per_pass * (4 + algo.train_vf_iters), per_pass, per_pass)
    lap("kernel update")
    if launches != expected:
        raise AssertionError(f"pipelined update launches {launches}, expected {expected}")
    plain = one_update(algo, params0, batch, device, on_mesh(mesh), plain_flash)[0]
    lap("plain update")
    flat, _, flat_launches, _, _ = one_update(algo, params0, batch, device)
    lap("unpipelined update")
    vs_plain = hold_update(kernel, plain, params0, steps, "pipelined: kernel vs plain")
    vs_flat = hold_update(kernel, flat, params0, steps, "pipelined vs unpipelined")
    stage_devices = mesh.axis_devices("pp")
    per_stage = n_layers // stages
    for i, block in enumerate(state.params.blocks):
        for p in block.parameters():
            moments = [state.pi_opt.state[p], state.vf_opt.state.get(p, {})]
            if not (p.is_leaf and p.device == stage_devices[i // per_stage]
                    and all(m["exp_avg"].device == p.device for m in moments if m)):
                raise AssertionError(f"blocks.{i} not on stage {i // per_stage}'s device")
    # The timed update is the profiled one's warm-up.
    ms, state = update_ms(update, state, batch, device)
    lap("timed update")
    busy = profile_device(lambda: update(state, {k: torch.as_tensor(v, device=device)
                                                 for k, v in batch.items()}), 1, "update",
                          cpu=False, warm=False)
    lap("profiled update")
    return {"seconds": seconds, "eval_err": eval_err, "eval_k1": eval_k1, "micro": micro, "per_pass": per_pass,
            "launches": launches, "flat_launches": flat_launches, "vs_plain": vs_plain,
            "vs_flat": vs_flat, "ms": ms, "busy": busy}


def mesh_moe(device, workdir: Path, learned: dict) -> dict:
    """Phase 21b: the MoE flagship (4 experts, top-2) under ``EP_MESH``:
    each ep device holds one expert's stacks; the first update through
    K1-K3 against the unsharded update on the card and against the same
    sharded update through the plain attention (phase 5's bars), every
    side's routes pinned to the unsharded kernel side's (phase 16's
    :func:`pinned_routes`), at exactly 336/4/4; ``expert_utilization`` of
    the placed params sums to 1 per layer."""
    from relayrl_tpu_torch.models.moe import expert_utilization
    from relayrl_tpu_torch.parallel.sharding import mesh_device, placement, shard_tensors

    algo = build_learner(device, workdir, MOE_ARCH)
    params0 = copy.deepcopy(algo.state.params)
    mesh = mesh_of(EP_MESH, device)
    batch = learned["batch"]
    pin, changes = route_pinning()
    sharded = lambda update: pin(on_mesh(mesh)(update))  # noqa: E731
    flat, _, flat_launches, steps, _ = one_update(algo, params0, batch, device, pin)
    kernel, state, launches, _, _ = one_update(algo, params0, batch, device, sharded)
    plain = one_update(algo, params0, batch, device, sharded, plain_flash)[0]
    n_layers = MOE_ARCH["n_layers"]
    expected = (n_layers * (4 + algo.train_vf_iters), n_layers, n_layers)
    if launches != expected or flat_launches != expected:
        raise AssertionError(f"ep update launches {launches} (unsharded {flat_launches}), "
                             f"expected {expected}")
    vs_flat = hold_update(kernel, flat, params0, steps, "ep vs unsharded")
    vs_plain = hold_update(kernel, plain, params0, steps, "ep: kernel vs plain")
    for block in state.params.layers():
        for leaf in ("moe_w_up", "moe_w_down"):
            shards = placement(block.moe, leaf)
            for t, coords in zip(shard_tensors(block.moe, leaf), shards.coords):
                if not (t.is_leaf and t.shape[0] == 1 and t.device == mesh_device(mesh, **coords)
                        and state.pi_opt.state[t]["exp_avg"].shape == t.shape):
                    raise AssertionError(f"{leaf} shard at {coords} misplaced")
    util = expert_utilization(algo.arch, state.params, batch["obs"])
    if not all(abs(float(u.sum()) - 1.0) <= 1e-5 for u in util.values()):
        raise AssertionError(f"ep expert utilization {util}")
    ms, _ = update_ms(on_mesh(mesh)(update_parts(algo, algo.policy, params0)[1]), state,
                      batch, device)
    return {"launches": launches, "flat_launches": flat_launches, "vs_flat": vs_flat,
            "vs_plain": vs_plain, "changes": dict(changes), "ms": ms,
            "util": {k: [round(float(x), 4) for x in v] for k, v in util.items()}}


def shard_bytes(state) -> dict:
    """Parameter and Adam moment bytes per mesh coordinate of a placed
    state, and its shard count: a shard at its coordinates (named by the
    split axes), every parameter that no rule splits at ``whole`` (the
    first device)."""
    from relayrl_tpu_torch.parallel.sharding import placement, shard_tensors

    moments = {}
    for opt in (state.pi_opt, state.vf_opt):
        for p, st in (opt.state.items() if opt is not None else ()):
            moments[id(p)] = sum(v.numel() * v.element_size() for v in st.values()
                                 if hasattr(v, "ndim") and v.ndim)
    rows, shards, placed = {}, 0, set()

    def add(where, t):
        row = rows.setdefault(where, {"tensors": 0, "param_bytes": 0, "moment_bytes": 0})
        row["tensors"] += 1
        row["param_bytes"] += t.numel() * t.element_size()
        row["moment_bytes"] += moments.get(id(t), 0)

    for module in state.params.modules():
        for leaf in list(getattr(module, "parametrizations", None) or {}):
            spec = placement(module, leaf)
            for t, coords in zip(shard_tensors(module, leaf), spec.coords):
                add(",".join(f"{k}{v}" for k, v in sorted(coords.items())) or "whole", t)
                placed.add(id(t))
                shards += 1
    for p in state.params.parameters():
        if id(p) not in placed:
            add("whole", p)
    return {"shards": shards, "per_coordinate": rows}


def mesh_fsdp_tp(device, workdir: Path, learned: dict) -> dict:
    """Phase 21c: the flagship and the cartpole golden's ``mlp_discrete``
    (f32, 128x128, its hyperparameters) under ``FSDP_TP_MESH``: each one's
    first update against its unsharded update on the card within the JAX
    test's f32 bars (whether bit-equal is reported); the flagship at
    exactly 336/4/4, the MLP at none; the placed state's bundle bytes
    equal to the unplaced state's; the shards and the bytes per mesh
    coordinate."""
    from relayrl_tpu_torch.algorithms import build_algorithm
    from relayrl_tpu_torch.envs import make
    from relayrl_tpu_torch.parallel import place_state
    from relayrl_tpu_torch.parallel.sharding import placement
    from relayrl_tpu_torch.types import ModelBundle
    from relayrl_tpu_torch.weights import params_to_jax

    mesh = mesh_of(FSDP_TP_MESH, device)
    cartpole = build_algorithm(
        "REINFORCE", env_dir=str(workdir / "mlp"), config_path=_local_config(workdir / "mlp"),
        obs_dim=4, act_dim=2, device=device, seed=SEED, seed_salt=0, **CARTPOLE_HP)
    cartpole_batch = epoch_batches(
        cartpole, random_episodes(make("CartPole-v1"), CARTPOLE_EPISODE_STEPS, SEED), 1)[0]
    out = {}
    n_layers = SLICE_ARCH["n_layers"]
    for name, algo, batch, expected in (
            ("flagship", build_learner(device, workdir / "flagship"), learned["batch"],
             (n_layers * (4 + LEARNER["train_vf_iters"]), n_layers, n_layers)),
            ("mlp_discrete", cartpole, cartpole_batch, (0, 0, 0))):
        params0 = copy.deepcopy(algo.state.params)
        kernel, state, launches, _, update = one_update(algo, params0, batch, device,
                                                        on_mesh(mesh))
        flat, _, flat_launches, _, _ = one_update(algo, params0, batch, device)
        if launches != expected or flat_launches != expected:
            raise AssertionError(f"{name} fsdp/tp launches {launches} (unsharded "
                                 f"{flat_launches}), expected {expected}")
        held = hold_f32(kernel, flat, f"{name} fsdp x tp vs unsharded")
        placed = place_state(update_parts(algo, algo.policy, copy.deepcopy(params0))[0], mesh)
        want = ModelBundle(1, algo.arch, params_to_jax(params0)).to_bytes()
        if ModelBundle(1, algo.arch, params_to_jax(placed.params)).to_bytes() != want:
            raise AssertionError(f"{name}: the placed state's bundle differs from the unplaced")
        if name == "mlp_discrete" and placement(state.params.pi_trunk.dense_0,
                                                "weight").spec != ("tp", "fsdp"):
            raise AssertionError("mlp_discrete's first kernel is not split (tp, fsdp)")
        ms, _ = update_ms(update, state, batch, device)
        out[name] = {**held, "launches": launches, "ms": ms, "bytes": shard_bytes(state),
                     "rows": tuple(batch["obs"].shape[:2])}
    return out


def mesh_entry(device, workdir: Path, learned: dict) -> dict:
    """Phase 21d: ``build_algorithm("REINFORCE", model_kind=
    "transformer_pp_discrete", ...)`` then ``enable_multihost`` over
    ``PP_MESH``; ``MESH_EPOCHS`` epochs from ``receive_trajectory`` on
    phase 5's first wave at exactly 2688/32/32 each; a port actor with no
    mesh loads the published bundle and serves it through K1 (n_layers a
    dispatch), its params sha256-equal to the learner's gathered params
    and to the publish snapshot's."""
    import numpy as np
    import torch

    from relayrl_tpu_torch.parallel import resolve_microbatches
    from relayrl_tpu_torch.runtime.vector_actor import VectorActorHost
    from relayrl_tpu_torch.weights import params_to_jax, tree_digest

    algo = build_learner(device, workdir, PP_ARCH)
    algo.enable_multihost(mesh_of(PP_MESH, device))
    n_layers, groups = PP_ARCH["n_layers"], PP_MESH["dp"]
    per_pass = n_layers * groups * resolve_microbatches(
        LEARNER["traj_per_epoch"] // groups, PP_MESH["pp"])
    expected = (per_pass * (4 + algo.train_vf_iters), per_pass, per_pass)
    per_update, seconds = [], []
    for records in learned["first_wave"][:MESH_EPOCHS * LEARNER["traj_per_epoch"]]:
        zero_flash_counts()
        t0 = time.perf_counter()
        updated = algo.receive_trajectory(records)
        torch.cuda.synchronize()
        if updated:
            seconds.append(time.perf_counter() - t0)
            per_update.append(flash_counts())
    if per_update != [expected] * MESH_EPOCHS or algo.version != MESH_EPOCHS:
        raise AssertionError(f"mesh learner launches {per_update} at version {algo.version}; "
                             f"expected {MESH_EPOCHS} x {expected}")
    bundle = algo.bundle()
    digest = tree_digest(bundle.params)
    snap = algo.snapshot_for_publish()
    host = VectorActorHost(bundle, MESH_ACTOR_LANES, seed=SEED, device=device)
    obs = np.random.default_rng(SEED).standard_normal(
        (MESH_ACTOR_LANES, algo.obs_dim)).astype(np.float32)
    zero_flash_counts()
    for _ in range(MESH_ACTOR_STEPS):
        host.request_for_actions(obs)
    torch.cuda.synchronize()
    served = flash_counts()
    if served != (n_layers * MESH_ACTOR_STEPS, 0, 0):
        raise AssertionError(f"actor launches {served} over {MESH_ACTOR_STEPS} dispatches")
    if not (tree_digest(params_to_jax(host.params)) == digest
            == tree_digest(snap.host_params())):
        raise AssertionError("the actor's params differ from the learner's gathered params")
    return {"per_update": per_update, "ms": [1e3 * s for s in seconds],
            "served": served, "digest": digest[:16], "version": algo.version}

def mh_rank_env(rank: int, port: int, cards: bool) -> dict:
    """A rank's environment: the coordinator, the world and its id (the
    server reads these), and its own card when the machine has one per
    rank."""
    env = {"RELAYRL_COORDINATOR": f"127.0.0.1:{port}",
           "RELAYRL_NUM_PROCESSES": str(MH_RANKS), "RELAYRL_PROCESS_ID": str(rank)}
    if cards:
        env["CUDA_VISIBLE_DEVICES"] = str(rank)
    return env


def rank_device():
    """A rank's card: the current one (its only one under
    ``CUDA_VISIBLE_DEVICES``)."""
    import torch

    return torch.device("cuda", torch.cuda.current_device())


def _digest(tree) -> str:
    from relayrl_tpu_torch.weights import tree_digest

    return tree_digest(tree)


def _allreduce_timer():
    """Wrap ``DataParallelGroup.all_reduce`` to time each call (device
    synced on both sides, so the collective's own time shows apart from
    the work queued before it); returns the stats dict and an undo."""
    import torch

    from relayrl_tpu_torch.parallel.distributed import DataParallelGroup

    stats = {"calls": 0, "bytes": 0, "s": 0.0}
    orig = DataParallelGroup.all_reduce

    def timed(self, flat):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(self, flat)
        torch.cuda.synchronize()
        stats["s"] += time.perf_counter() - t0
        stats["calls"] += 1
        stats["bytes"] += flat.numel() * flat.element_size()
        return out

    DataParallelGroup.all_reduce = timed
    return stats, lambda: setattr(DataParallelGroup, "all_reduce", orig)


def mh_rank_main(rank: int, port: int, workdir: Path) -> int:
    """One rank of phase 22 (a) and (c) (``chip_smoke.py --mh-rank RANK
    PORT WORKDIR``, started by :func:`multiprocess_learner`): forms the
    process group, receives the coordinator's batches through the
    broadcast, and trains over a dp axis that spans the ranks. Writes its
    results to ``WORKDIR/rank<RANK>.pt``."""
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from relayrl_tpu_torch.algorithms.onpolicy import read_metrics
    from relayrl_tpu_torch.parallel import (
        broadcast_from_coordinator,
        distributed,
        initialize_distributed,
        is_coordinator,
        make_mesh,
    )
    from relayrl_tpu_torch.weights import logical_state, params_to_jax

    root = Path(__file__).resolve().parent
    info = initialize_distributed(f"127.0.0.1:{port}", MH_RANKS, rank)
    if info != {"multi_host": True, "process_id": rank, "num_processes": MH_RANKS} \
            or is_coordinator() != (rank == 0):
        raise AssertionError(f"rank {rank}: topology {info}")
    device = rank_device()
    batches = torch.load(workdir / "batches.pt", weights_only=False)
    out = {"info": info, "backend": distributed.backend(),
           "card": torch.cuda.get_device_name(device), "a": {}, "c": {}}

    def mesh():
        m = make_mesh({"dp": -1}, [device])
        if m.shape["dp"] != MH_RANKS or m.process_count != MH_RANKS:
            raise AssertionError(f"mesh {m.shape} over {m.process_count} processes")
        return m

    # (a) phase 5's batches, each one update from phase 5's initial params.
    for case, want in batches.items():
        algo = build_learner(device, workdir / f"rank{rank}_{case}")
        params0 = _digest(params_to_jax(algo.state.params))
        algo.enable_multihost(mesh())
        zero = algo.mh_zero_batch(*want["obs"].shape[:2])
        if {k: (v.shape, v.dtype) for k, v in zero.items()} != \
                {k: (v.shape, v.dtype) for k, v in want.items()}:
            raise AssertionError(f"mh_zero_batch's schema differs from the batch's")
        batch = broadcast_from_coordinator(want if rank == 0 else zero)
        if not all(np.array_equal(batch[k], want[k]) and batch[k].dtype == want[k].dtype
                   for k in want):
            raise AssertionError(f"rank {rank}: the broadcast batch differs")
        zero_flash_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        algo.train_on_batch(batch)
        metrics = read_metrics(algo._last_metrics)
        torch.cuda.synchronize()
        first_ms = 1e3 * (time.perf_counter() - t0)
        counts = flash_counts()
        result = {"params0": params0, "counts": counts, "metrics": metrics,
                  "first_ms": first_ms,
                  "params": {k: v.detach().cpu().clone() for k, v in
                             logical_state(algo.state.params).items()},
                  "digest": _digest(params_to_jax(algo.state.params))}
        if case == "even":
            # Steady updates, then one with the all-reduces timed apart.
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(MH_TIMED):
                algo.train_on_batch(batch)
            read_metrics(algo._last_metrics)
            torch.cuda.synchronize()
            result["ms"] = 1e3 * (time.perf_counter() - t0) / MH_TIMED
            stats, undo = _allreduce_timer()
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                algo.train_on_batch(batch)
                read_metrics(algo._last_metrics)
                torch.cuda.synchronize()
                result["timed_ms"] = 1e3 * (time.perf_counter() - t0)
            finally:
                undo()
            result["allreduce"] = stats
            result["steady_digest"] = _digest(params_to_jax(algo.state.params))
        out["a"][case] = result

    # (c) the off-policy family: the coordinator samples, every rank trains.
    for i, name in enumerate(MH_OFF_ALGOS):
        algo, env_id = build_offpolicy(device, root, name, workdir / f"rank{rank}_{name}")
        sampled = []
        if rank == 0:
            for ep in random_episodes(env_id, algo.update_after + algo.batch_size, SEED + i):
                algo.buffer.add_episode(ep)
            sampled = [algo.buffer.sample(algo.batch_size) for _ in range(MH_OFF_UPDATES)]
        algo.enable_multihost(mesh())

        def step(batch):
            batch = broadcast_from_coordinator(
                batch if rank == 0 else algo.mh_zero_batch(algo.batch_size, 0))
            algo.train_on_batch(batch)

        metrics = []
        zero_flash_counts()
        for batch in (sampled or [None] * MH_OFF_UPDATES):
            step(batch)
            metrics.append(read_metrics(algo._last_metrics))
        state = {f: {n: p.detach().cpu().clone() for n, p in m.named_parameters()}
                 for f, m in vars(algo.state).items() if isinstance(m, torch.nn.Module)}
        out["c"][name] = {"metrics": metrics, "state": state, "batches": sampled,
                          "digest": _digest(algo.state_trees()), "version": algo.version}
        # Steady updates as the server's loop runs them: a broadcast sample,
        # then the update.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MH_OFF_TIMED):
            step(algo.buffer.sample(algo.batch_size) if rank == 0 else None)
        read_metrics(algo._last_metrics)
        torch.cuda.synchronize()
        out["c"][name].update(ms=1e3 * (time.perf_counter() - t0) / MH_OFF_TIMED,
                              counts=flash_counts(),
                              steady_digest=_digest(algo.state_trees()))
    torch.save(out, workdir / f"rank{rank}.pt")
    distributed.barrier()
    distributed.shutdown_distributed()
    print(f"[mh-rank {rank}] done ({out['backend']} on {out['card']})", flush=True)
    return 0


def run_ranks(root: Path, workdir: Path, args, envs: list[dict],
              timeout_s: float = MH_TIMEOUT_S) -> None:
    """Start one ``chip_smoke.py`` process per rank (``subprocess``, never a
    fork of this CUDA process) with ``args(rank)`` and its env, wait for all
    under one deadline, and fail the phase if one fails or the deadline
    passes (every process is killed then)."""
    import os

    procs, logs = [], []
    for rank, env in enumerate(envs):
        log = open(workdir / f"rank{rank}.log", "wb")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(root / "chip_smoke.py"), *[str(a) for a in args(rank)]],
            cwd=str(root), env=dict(os.environ, PYTHONPATH=str(root), **env),
            stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                what = (f"rank {failed[0]} exited {procs[failed[0]].returncode}"
                        if failed else f"ranks still running after {timeout_s:.0f} s")
                raise AssertionError(f"phase 22: {what}:\n" + "\n".join(
                    f"--- rank {r}:\n" + (workdir / f"rank{r}.log").read_bytes()[-3000:]
                    .decode(errors="replace") for r in range(len(procs))))
            time.sleep(0.2)
        for rank, p in enumerate(procs):
            if p.returncode != 0:
                raise AssertionError(f"phase 22: rank {rank} exited {p.returncode}:\n"
                                     + (workdir / f"rank{rank}.log").read_bytes()[-3000:]
                                     .decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        for log in logs:
            log.close()


def uneven_batch(batch: dict) -> dict:
    """``batch`` with its rank-1 rows (the second half) mostly padding:
    row ``4 + i`` keeps ``MH_UNEVEN_LENGTHS[i]`` valid steps."""
    import numpy as np

    out = {k: np.array(v) for k, v in batch.items()}
    half = len(out["valid"]) // MH_RANKS
    for i, length in enumerate(MH_UNEVEN_LENGTHS):
        row = half + i
        out["valid"][row, length:] = 0.0
        for key in ("rew", "val", "logp"):
            out[key][row, length:] = 0.0
        out["last_val"][row] = 0.0
    return out


def hold_offpolicy(name: str, ref, rank_out: dict, batches: list) -> dict:
    """The single-process updates of ``ref`` (built as the ranks built
    theirs) on the coordinator's sampled ``batches``, against rank 0's:
    phase 15's card-vs-CPU bars (metrics within ``MLP_METRIC_RTOL`` x |m|
    + ``MLP_METRIC_ATOL``; every parameter within ``MLP_PARAM_ATOL``,
    except where the reference's RMS gradient fell below ``ADAM_FLOOR``:
    there Adam's step bound; a target takes its online element's rule)."""
    import torch

    from relayrl_tpu_torch.algorithms.onpolicy import read_metrics

    least_rms = {}

    def track_rms(opt, args, kwargs):
        beta2 = opt.param_groups[0]["betas"][1]
        for p, st in opt.state.items():
            rms = st["exp_avg_sq"].sqrt() / math.sqrt(1 - beta2 ** float(st["step"]))
            least_rms[p] = torch.minimum(least_rms[p], rms) if p in least_rms else rms

    opts = [o for o in vars(ref.state).values() if isinstance(o, torch.optim.Optimizer)]
    for opt in opts:
        opt.register_step_post_hook(track_rms)
    want_m = []
    for batch in batches:
        ref.train_on_batch(batch)
        want_m.append(read_metrics(ref._last_metrics))
    metric_err = param_err = 0.0
    for got, want in zip(rank_out["metrics"], want_m):
        for key, value in want.items():
            err = abs(got[key] - value)
            if not err <= MLP_METRIC_RTOL * abs(value) + MLP_METRIC_ATOL:
                raise AssertionError(f"{name} metric {key}: dp 2 across ranks {got[key]} "
                                     f"vs one process {value}")
            metric_err = max(metric_err, err)
    bound_of = {p: o.param_groups[0]["lr"] * float(o.state[p]["step"])
                for o in opts for p in o.param_groups[0]["params"]}
    n_floored = 0
    for field, module in vars(ref.state).items():
        if not isinstance(module, torch.nn.Module):
            continue
        online = dict(getattr(ref.state, field.removeprefix("target_")).named_parameters())
        got = rank_out["state"][field]
        for pname, p in module.named_parameters():
            diff = (got[pname].to(p.device) - p.detach()).abs()
            noise = least_rms[online[pname]] < ADAM_FLOOR
            bound = torch.where(noise, bound_of[online[pname]], MLP_PARAM_ATOL)
            if not bool((diff <= bound).all()):
                raise AssertionError(f"{name} {field}.{pname}: dp 2 across ranks vs one "
                                     f"process {diff.max().item()}")
            param_err = max(param_err, diff.where(~noise, 0.0).max().item())
            n_floored += int(noise.sum())
    return {"metric_err": metric_err, "param_err": param_err, "n_floored": n_floored}


def multiprocess_learner(device, root: Path, workdir: Path, learned: dict) -> dict:
    """Phase 22 (a) and (c): ``MH_RANKS`` rank processes
    (:func:`mh_rank_main`). (a) Phase 5's first batch and its uneven copy
    (:func:`uneven_batch`), broadcast bit for bit from rank 0; one update
    each under dp 2 across the ranks from phase 5's initial params: the
    ranks' params sha256-equal, each rank at 336/4/4 launches, and the
    update held to this process's single-process update of the same batch
    from the same params at phase 5's kernel-vs-plain bars
    (:func:`hold_update`); ms per update and the all-reduces' share. (c)
    DQN and SAC at their goldens' widths: the coordinator fills its ring
    and samples, ``MH_OFF_UPDATES`` updates under dp 2, the ranks'
    networks sha256-equal and held to single-process updates on the same
    batches (:func:`hold_offpolicy`)."""
    import shutil

    import torch

    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    algo, params0 = learned["algo"], learned["params0"]
    batches = {"even": learned["batch"], "uneven": uneven_batch(learned["batch"])}
    torch.save(batches, workdir / "batches.pt")
    refs = {}
    for case, batch in batches.items():
        ref_side, _, ref_counts, steps, _ = one_update(algo, params0, batch, device)
        refs[case] = (ref_side, ref_counts, steps)
    port = _free_port()
    cards = torch.cuda.device_count() >= MH_RANKS
    t0 = time.perf_counter()
    run_ranks(root, workdir, lambda r: ["--mh-rank", r, port, workdir],
              [mh_rank_env(r, port, cards) for r in range(MH_RANKS)])
    wall = time.perf_counter() - t0
    ranks = [torch.load(workdir / f"rank{r}.pt", weights_only=False)
             for r in range(MH_RANKS)]
    backends = {r["backend"] for r in ranks}
    want_backend = "nccl" if cards else "gloo"
    if backends != {want_backend}:
        raise AssertionError(f"backends {backends}; the rule says {want_backend}")
    from relayrl_tpu_torch.weights import params_to_jax

    start = _digest(params_to_jax(params0))
    n_layers = SLICE_ARCH["n_layers"]
    expected = (n_layers * (4 + LEARNER["train_vf_iters"]), n_layers, n_layers)
    out = {"wall": wall, "backend": want_backend, "cards": [r["card"] for r in ranks],
           "a": {}, "c": {}}
    for case, (ref_side, ref_counts, steps) in refs.items():
        rs = [r["a"][case] for r in ranks]
        if any(r["params0"] != start for r in rs):
            raise AssertionError(f"{case}: a rank's initial params differ from phase 5's")
        if len({r["digest"] for r in rs}) != 1 or rs[0]["metrics"] != rs[1]["metrics"]:
            raise AssertionError(f"{case}: the ranks' params or metrics differ")
        if any(r["counts"] != expected for r in rs) or ref_counts != expected:
            raise AssertionError(f"{case}: launches per rank {[r['counts'] for r in rs]}, "
                                 f"one process {ref_counts}; expected {expected}")
        got = ({k: v.to(device) for k, v in rs[0]["params"].items()}, rs[0]["metrics"])
        held = hold_update(got, ref_side, params0, steps,
                           f"{case}: dp {MH_RANKS} across ranks vs one process")
        out["a"][case] = {**held, "counts": [r["counts"] for r in rs],
                          "first_ms": [r["first_ms"] for r in rs],
                          "digest": rs[0]["digest"][:16]}
    even = [r["a"]["even"] for r in ranks]
    if len({r["steady_digest"] for r in even}) != 1:
        raise AssertionError("the ranks' params differ after the timed updates")
    out["ms"] = [r["ms"] for r in even]
    out["timed_ms"] = [r["timed_ms"] for r in even]
    out["allreduce"] = [r["allreduce"] for r in even]
    for i, name in enumerate(MH_OFF_ALGOS):
        rs = [r["c"][name] for r in ranks]
        if len({r["digest"] for r in rs}) != 1 or rs[0]["metrics"] != rs[1]["metrics"] \
                or {r["version"] for r in rs} != {MH_OFF_UPDATES} \
                or len({r["steady_digest"] for r in rs}) != 1:
            raise AssertionError(f"{name}: the ranks' networks, metrics or versions differ")
        if any(r["counts"] != (0, 0, 0) for r in rs):
            raise AssertionError(f"{name}: flash kernels launched {[r['counts'] for r in rs]}")
        ref, _ = build_offpolicy(device, root, name, workdir / f"single_{name}")
        held = hold_offpolicy(name, ref, rs[0], rs[0]["batches"])
        out["c"][name] = {**held, "ms": [r["ms"] for r in rs], "digest": rs[0]["digest"][:16]}
    return out


def multiprocess_server(device, root: Path, workdir: Path) -> dict:
    """Phase 22 (b): phase 11's learner as a two-rank ``TrainingServer``
    (``examples/chaos_server.py`` per rank, the default config, the
    checkpoint directory shared) fed over ZMQ by a ``VectorAgent`` of
    ``MH_LANES`` ``RecallEnv(255)`` lanes in this process, one epoch a wave:
    after each wave both ranks at the same version and the agent installed
    it. Then both ranks stop: the same params (sha256), 336/4/4 launches
    per update each, only the coordinator with a transport and publishes,
    exact accounting (trajectories sent == accepted == trained), the
    collective checkpoint on disk. Then both resume from it and train
    ``MH_RESUME_UPDATES`` more, held the same way, the accounting exact
    across the resume."""
    import shutil

    import torch

    from relayrl_tpu_torch.checkpoint.manager import CheckpointManager
    from relayrl_tpu_torch.envs import RecallEnv, SyncVectorEnv
    from relayrl_tpu_torch.runtime.agent import VectorAgent
    from relayrl_tpu_torch.runtime.vector_actor import run_vector_gym_loop

    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    server_addrs, agent_addrs = zmq_addrs()
    env = RecallEnv(LEARNER_HORIZON, N_CUES)
    arch = SLICE_ARCH
    hyperparams = {"model_kind": arch["kind"], "seed": SEED,
                   **{k: v for k, v in arch.items()
                      if k not in ("kind", "has_critic", "precision")},
                   **LEARNER}
    ckpt_dir = workdir / "checkpoints"
    cards = torch.cuda.device_count() >= MH_RANKS
    n_layers = arch["n_layers"]
    per_update = (n_layers * (4 + LEARNER["train_vf_iters"]), n_layers, n_layers)
    agent_config = workdir / "agent_config.json"
    agent_config.write_text(json.dumps({}))

    def start(resume: bool, tag: str):
        port = _free_port()
        servers = []
        for rank in range(MH_RANKS):
            cfg = {"algorithm": "REINFORCE",
                   "obs_dim": int(env.observation_space.shape[0]),
                   "act_dim": int(env.action_space.n), "hyperparams": hyperparams,
                   "scratch": str(workdir / f"rank{rank}"),
                   "checkpoint_every": MH_SERVER_UPDATES,
                   "config": {"learner": {"precision": arch["precision"],
                                          "checkpoint_dir": str(ckpt_dir)}},
                   "digests": True, "resume": resume,
                   "status_path": str(workdir / f"status{rank}_{tag}.json"),
                   "stop_path": str(workdir / f"stop_{tag}"), **server_addrs}
            servers.append(ChaosServer(root, cfg, workdir / f"rank{rank}_{tag}.log",
                                       env=mh_rank_env(rank, port, cards)))
        return servers

    def stop(servers, tag):
        (workdir / f"stop_{tag}").write_text("stop")
        finals = [s.wait(lambda st: st.get("final"), "the rank's final status",
                         timeout_s=MH_TIMEOUT_S) for s in servers]
        for s in servers:
            s.stop()
        return finals

    def hold(finals, updates, what):
        states = [f["state"] for f in finals]
        if len({(st["version"], st["params"]) for st in states}) != 1 \
                or states[0]["version"] != updates[1]:
            raise AssertionError(f"{what}: the ranks' states {states}")
        for rank, f in enumerate(finals):
            if f["distributed"] != {"multi_host": True, "process_id": rank,
                                    "num_processes": MH_RANKS}:
                raise AssertionError(f"{what}: rank {rank} topology {f['distributed']}")
            stats = f["stats"]
            if stats["learner_errors"] or stats["publish_errors"] or stats["dropped"]:
                raise AssertionError(f"{what}: rank {rank} {stats} "
                                     f"{f['last_learner_error']}")
            counts = tuple(f["kernels"][k] for k in ("flash_fwd", "flash_dq", "flash_dkv"))
            n = updates[1] - updates[0]
            if counts != tuple(n * c for c in per_update) or stats["updates"] != n:
                raise AssertionError(f"{what}: rank {rank} launches {counts} over "
                                     f"{stats['updates']} updates; expected {n} x "
                                     f"{per_update}")
            published = sum(len(v) for v in f["publish_bytes"].values())
            if (f["transport"] != "NoneType") != (rank == 0) or \
                    (published > 0) != (rank == 0):
                raise AssertionError(f"{what}: rank {rank} transport {f['transport']}, "
                                     f"{published} publishes")
        check_clean_guardrails(finals[0])
        return [tuple(f["kernels"][k] for k in ("flash_fwd", "flash_dq", "flash_dkv"))
                for f in finals]

    servers = start(False, "a")
    agent = None
    try:
        for s in servers:
            s.wait(lambda st: True, "the rank to come up", timeout_s=MH_TIMEOUT_S)
        agent = VectorAgent(num_envs=MH_LANES, config_path=str(agent_config), seed=SEED,
                            probe=False, device=device,
                            model_path=str(workdir / "client_model.rlx"), **agent_addrs)
        venv = SyncVectorEnv([lambda: RecallEnv(LEARNER_HORIZON, N_CUES)] * MH_LANES)
        waves, seconds, agent_k1, dispatches = 0, [], 0, 0

        def train(servers, first, last):
            nonlocal waves, agent_k1, dispatches
            for version in range(first + 1, last + 1):
                zero_flash_counts()
                d0 = agent.host.dispatches
                t0 = time.perf_counter()
                run_vector_gym_loop(agent, venv, LEARNER_HORIZON, seed=SEED + waves)
                waves += 1
                servers[0].wait(
                    lambda st: (st["version"] == version and agent.model_version == version
                                and (st.get("published") or {}).get("version") == version),
                    f"version {version} published and installed", timeout_s=MH_TIMEOUT_S)
                for s in servers[1:]:
                    s.wait(lambda st: st["algo_version"] == version,
                           f"rank at version {version}", timeout_s=MH_TIMEOUT_S)
                seconds.append(time.perf_counter() - t0)
                agent_k1 += flash_counts()[0]
                dispatches += agent.host.dispatches - d0

        train(servers, 0, MH_SERVER_UPDATES)
        lanes = list(agent.agent_ids)
        finals = stop(servers, "a")
        counts_a = hold(finals, (0, MH_SERVER_UPDATES), "(b) before the resume")
        sent = agent.spool.sent_counts()
        for lane in lanes:
            row = finals[0]["accounting"]["agents"].get(lane)
            if row != {"max_seq": sent[lane], "accepted": sent[lane], "contiguous": True}:
                raise AssertionError(f"(b) accounting of {lane}: {row}, sent {sent[lane]}")
        if (finals[0]["stats"]["trajectories"] != MH_SERVER_UPDATES * LEARNER["traj_per_epoch"]
                or finals[0]["accounting"]["duplicates"]):
            raise AssertionError(f"(b) trajectories {finals[0]['stats']}, duplicates "
                                 f"{finals[0]['accounting']['duplicates']} for "
                                 f"{MH_SERVER_UPDATES} updates")
        if CheckpointManager(str(ckpt_dir)).latest_step() != MH_SERVER_UPDATES:
            raise AssertionError("(b) no collective checkpoint at the last update")
        checkpoint = finals[0]["state"]

        servers = start(True, "b")
        resumed = [s.wait(lambda st: True, "the resumed rank", timeout_s=MH_TIMEOUT_S)
                   for s in servers]
        if any(r["resume"] != checkpoint for r in resumed):
            raise AssertionError(f"(b) resumed {[r['resume'] for r in resumed]} != "
                                 f"{checkpoint}")
        total = MH_SERVER_UPDATES + MH_RESUME_UPDATES
        train(servers, MH_SERVER_UPDATES, total)
        finals = stop(servers, "b")
        counts_b = hold(finals, (MH_SERVER_UPDATES, total), "(b) after the resume")
        sent = agent.spool.sent_counts()
        for lane in lanes:
            row = finals[0]["accounting"]["agents"].get(lane)
            if row != {"max_seq": sent[lane], "accepted": sent[lane], "contiguous": True}:
                raise AssertionError(f"(b) accounting after the resume of {lane}: {row}, "
                                     f"sent {sent[lane]}")
        # The agent's spool replays what it sent before the teardown; the
        # restored ledger drops those replays (counted as duplicates), so
        # the resumed server trains only the new epochs.
        if (sum(sent.values()) != total * LEARNER["traj_per_epoch"]
                or finals[0]["stats"]["trajectories"]
                != MH_RESUME_UPDATES * LEARNER["traj_per_epoch"]):
            raise AssertionError(f"(b) {sum(sent.values())} trajectories sent for {total} "
                                 f"updates; after the resume {finals[0]['stats']}")
        if agent_k1 != (n_layers - 1) * dispatches:
            raise AssertionError(f"(b) agent launches {agent_k1} over {dispatches} dispatches")
        return {"seconds": seconds, "counts": [counts_a, counts_b],
                "replayed": finals[0]["accounting"]["duplicates"],
                "agent_k1": agent_k1, "version": finals[0]["state"]["version"],
                "digest": finals[0]["state"]["params"][:16], "waves": waves,
                "sent": sum(sent.values())}
    finally:
        if agent is not None:
            agent.disable_agent()
        for s in servers:
            s.stop()


def nccl_shared_card_probe(rank: int, port: int) -> int:
    """``chip_smoke.py --nccl-shared-card-probe RANK PORT``: one rank of
    two that put an ``nccl`` group on the same card (cuda:0) and sum one
    tensor; prints what NCCL did. Gates nothing: it checks the backend
    rule's reason (ranks that share a card take gloo)."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    store = dist.TCPStore("127.0.0.1", port, MH_RANKS, is_master=rank == 0,
                          timeout=datetime.timedelta(seconds=60))
    try:
        dist.init_process_group("nccl", store=store, rank=rank, world_size=MH_RANKS,
                                timeout=datetime.timedelta(seconds=60))
        x = torch.ones(4, device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        print(f"[nccl-probe {rank}] all_reduce on a shared card returned {x.tolist()}",
              flush=True)
    except Exception as e:  # the probe reports what NCCL raised
        print(f"[nccl-probe {rank}] refused: {type(e).__name__}: {e}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


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
    steps_per_s = serve_steps_per_s = LANES * DISPATCHES / run["wall"]
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
          f"{recall['kernel_err']:.3e} (tol {MLP_PARAM_ATOL:g}, or {PLAIN_NOISE_FACTOR:g} x "
          f"the plain attention's card-vs-cpu diff, max {recall['plain_err']:.3e}: "
          f"{recall['n_relative']} element(s) passed by that rule alone); "
          + ", ".join(f"{k} {recall['delta_errs'][k]:.3e} (bar {recall['delta_bars'][k]:.3e}: "
                      f"the metric bar or {PLAIN_NOISE_FACTOR:g} x the plain sides' largest)"
                      for k in recall["delta_bars"]) + "; "
          f"{recall['n_floored']} elements below Adam's floor {ADAM_FLOOR:g}, max diff there "
          f"{recall['floor_err']:.3e} (tol lr x steps); qkv key bias: card gradient "
          f"{recall['key_grad']:.3e} (q and v thirds' median {recall['qv_grad']:.3e}), each "
          f"side's largest move {recall['key_moved']:.6f} x lr x steps (tol "
          f"{KEY_BIAS_SLACK:g})", flush=True)
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
    steps_per_s = dist_steps_per_s = DIST_LANES * dist["dispatches"] / dist["wall"]
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

    # 13. the async fleet over the native plane, through a relay
    fleet = async_fleet(device, root, root / "build" / "chip_smoke_fleet", learned)
    f_fwd, f_dq, f_dkv = fleet["server_counts"]
    fa_fwd = fleet["agent_counts"][0]
    plain, cpu = fleet["plain"], fleet["cpu"]
    print(f"[fleet] IMPALA first update on phase 5's first batch (behavior log-probs "
          f"from the f32 model): launches "
          f"(flash_fwd, flash_dq, flash_dkv) {fleet['first_counts']}; kernels vs plain "
          f"attention max metric diff {plain['metric_err']:.3e} (tol "
          f"{UPDATE_METRIC_TOL:g} x max(1, |m|)), max param diff {plain['param_err']:.3e} "
          f"(tol 2 x Adam step bound), mean param diff {plain['mean_diff_share']:.4f} of "
          f"the mean movement (tol {UPDATE_MEAN_DIFF_SHARE:g}); RhoMean "
          f"{plain['metrics']['RhoMean']:.6g}, KL {plain['metrics']['KL']:.6g}; card vs "
          f"cpu (f32): max metric diff {cpu['metric_err']:.3e}, max param diff "
          f"{cpu['param_err']:.3e} (tol {MLP_PARAM_ATOL:g}); {cpu['n_floored']} elements "
          f"below Adam's floor {ADAM_FLOOR:g}, max diff there {cpu['floor_err']:.3e} "
          f"(tol lr x steps)", flush=True)
    print("[fleet] (not gated) the same first update on the actors' behavior log-probs, "
          "kernels vs plain attention: " + ", ".join(
              f"{k} {a:.6g} vs {b:.6g}" for k, (a, b) in fleet["on_actors"].items()),
          flush=True)
    print(f"[fleet] (not gated) IMPALA update in this process: {fleet['update_ms']:.2f} "
          f"ms per update (updates 2-4 of [{IMPALA_HP['traj_per_epoch']}, "
          f"{IMPALA_HP['bucket_lengths'][0]}], synchronized) on {smi.splitlines()[0]}",
          flush=True)
    print(f"[fleet] chaos_server IMPALA over native + relay process (native up, zmq "
          f"down): agent A {DIST_LANES} lanes through the relay (zmq), agent B "
          f"{FLEET_LANES_B} lanes direct (native); {fleet['updates']} updates; server "
          f"launches {fleet['server_counts']} = {fleet['updates']} x "
          f"{fleet['per_update']}; agents' flash_fwd {fa_fwd} = "
          f"{SLICE_ARCH['n_layers'] - 1} x {sum(fleet['dispatches'].values())} "
          f"dispatches; decoders {fleet['decoded']} for {fleet['trajectories']} "
          f"trajectories; A and B at version {fleet['digests']['A'][0]} sha256-equal to "
          f"the publish ({fleet['digests']['A'][1][:16]})", flush=True)
    print(f"[fleet] relay SIGKILL at version {fleet['v_kill']}, a wave into the "
          f"outage, replacement on the same spool: A at version {fleet['a_version']}; "
          f"accepted == max_seq == sent, contiguous, trained == sent "
          f"({fleet['trajectories']}), {fleet['duplicates']} duplicate(s) dropped; "
          f"replacement relay served {fleet['relay']['resyncs_served']:g} resync(s) from "
          f"its cached keyframe ({fleet['relay']['keyframe_cache_hits']:g} cache hits), "
          f"forwarded {fleet['relay']['trajectory_frames_forwarded']:g} trajectory "
          f"frames; RhoMean per update {[round(r, 4) for r in fleet['rho_mean']]}",
          flush=True)
    prof = fleet["profile"]
    hops = "; ".join(
        f"{kind} {[round(h, 2) for h in hop]} ms"
        + (f" (median {sorted(hop)[len(hop) // 2]:.2f})" if hop else " (not measured)")
        for kind, hop in fleet["hop_ms"].items())
    print(f"[fleet] (not gated) staging decode of B's payloads "
          f"({fleet['payload_bytes']:.0f} bytes): native codec "
          f"{fleet['native_ms']:.4f} ms vs Python {fleet['python_ms']:.4f} ms per "
          f"trajectory; relay hop's added latency (A through the relay minus B "
          f"direct, per version; both agents share this process): {hops}"
          + f"; server learner: dispatch {prof['timings_ms']['dispatch_s']:.2f} ms, "
          f"fence {prof['timings_ms']['device_wait_s']:.2f} ms, device busy "
          + ("not measured" if prof.get("device_busy_ms") is None else
             f"{prof['device_busy_ms']:.2f} ms")
          + f" per update over {prof['updates']} updates; {fleet['wall']:.1f} s for "
          f"{FLEET_WAVES} waves of both agents; on {smi.splitlines()[0]}", flush=True)

    # 14. PPO on the flagship, in-process
    ppo = ppo_learner(device, root / "build" / "chip_smoke_ppo", learned)
    p_fwd, p_dq, p_dkv = ppo["launches"]
    plain, cpu, stop = ppo["plain"], ppo["cpu"], ppo["stop_metrics"]
    print(f"[ppo] first update ({PPO_UPDATE_MINIBATCHES} minibatches of "
          f"[{PPO_MINIBATCH_ROWS}, {SLICE_ARCH['max_seq_len']}]) kernels vs plain "
          f"attention: max metric diff {plain['metric_err']:.3e}, max param diff "
          f"{plain['param_err']:.3e} (tol 2 x Adam step bound), mean param diff "
          f"{plain['mean_diff_share']:.4f} of the mean movement; card vs cpu (f32, same "
          f"index sets): max metric diff {cpu['metric_err']:.3e}, max param diff "
          f"{cpu['param_err']:.3e}; {cpu['n_floored']} elements below Adam's floor, max "
          f"diff there {cpu['floor_err']:.3e}; StopIter {plain['metrics']['StopIter']:g}",
          flush=True)
    print(f"[ppo] KL stop (target_kl -1): StopIter {stop['StopIter']:g} on the card and "
          f"{ppo['cpu_stop']['metrics']['StopIter']:g} at f32 vs the cpu; pi params and "
          f"pi Adam state (steps 1) bit-equal to the first minibatch's", flush=True)
    steady = ppo["seconds"][1:]
    print(f"[ppo] {ppo['updates']} updates on phase 5's first wave: launches per update "
          f"{ppo['per_update']} (16 minibatches x {SLICE_ARCH['n_layers']} layers); "
          f"(not gated) {1e3 * sum(steady) / len(steady):.2f} ms per update over updates "
          f"2-{ppo['updates']} (first {1e3 * ppo['seconds'][0]:.2f} ms) on "
          f"{smi.splitlines()[0]}", flush=True)
    print(f"[ppo] learning on the card: PPO CartPole-v1 avg return "
          f"{ppo['cartpole']['avg_return_last_window']:.2f} after {PPO_CARTPOLE_EPOCHS} "
          f"epochs (bar {PPO_CARTPOLE_BAR:g}); IMPALA from stale behavior, "
          f"{STALE_EPISODES} episodes, {ppo['stale_updates']} updates: P(action 1) "
          f"{ppo['p_one']:.4f} (bar {STALE_BAR:g}), RhoMean in (0, 1]", flush=True)

    # 15. the off-policy family on the card
    zero_flash_counts()
    zero_ring_counts()
    offp = offpolicy_learners(device, root, root / "build" / "chip_smoke_offpolicy")
    for name, r in offp.items():
        print(f"[offpolicy] {name} ({OFFPOLICY_GOLDENS[name]}: {r['env']}, f32 MLP "
              f"{'x'.join(map(str, r['hidden']))}, batch {r['batch']}, ring {r['ring']}): "
              f"one update card vs cpu on the same batch and noise: max metric diff "
              f"{r['metric_err']:.3e}, max param diff {r['param_err']:.3e} (tol "
              f"{MLP_PARAM_ATOL:g}); {r['n_floored']} elements below Adam's floor "
              f"{ADAM_FLOOR:g}, max diff there {r['floor_err']:.3e} (tol lr x steps); "
              f"updates_per_dispatch {OFFPOLICY_FUSED} vs {OFFPOLICY_FUSED} single updates "
              f"bit-equal over {r['fused_tensors']} tensors; (not gated) {r['ms']:.3f} ms "
              f"per gradient update over {OFFPOLICY_TIMED}, device busy "
              + ("not measured" if r["profile"] is None else
                 f"{r['profile']['busy_ms']:.4f} ms in {r['profile']['operations']:.0f} "
                 f"operations")
              + f" per update, on {smi.splitlines()[0]}", flush=True)
    off_local = offpolicy_local(device, root, root / "build" / "chip_smoke_offpolicy_local")
    for name, r in off_local.items():
        print(f"[offpolicy] LocalRunner {name} at its golden's config: {r['updates']} "
              f"updates (episodes that trained) = {r['grad_updates']} gradient updates, "
              f"{r['steps']} env steps in {r['wall']:.2f} s ({r['steps'] / r['wall']:.1f} env "
              f"steps/s, learner included) on {smi.splitlines()[0]}; versions advance with "
              f"every hot swap, returns finite (avg {r['avg_return']:.1f})"
              + ("" if r["epsilon"] is None else
                 f", epsilon annealed into every bundle (last {r['epsilon']:.4f})"),
              flush=True)
    off_counts = flash_counts() + ring_counts()
    if any(off_counts):
        raise AssertionError(f"flash/ring kernels launched on the off-policy paths: "
                             f"{off_counts}")
    off_dist = offpolicy_server(device, root, root / "build" / "chip_smoke_offpolicy_dist")
    print(f"[offpolicy] DQN chaos_server over ZMQ (default config, guardrails on) + "
          f"VectorAgent ({OFFPOLICY_LANES} CartPole lanes): {off_dist['grad_updates']} "
          f"gradient updates over {off_dist['updates']} ingests that trained (the list "
          f"branch), {off_dist['trajectories']} trajectories, accepted == max_seq == sent; "
          f"agent params at the last publish sha256-equal ({off_dist['digest'][:16]}), "
          f"epsilon {off_dist['epsilon']:.4f}; flash/ring launches 0 in both processes; "
          f"(not gated) {off_dist['steps'] / off_dist['wall']:.1f} env steps/s at the agent, "
          f"server dispatch {1e3 * off_dist['timings']['dispatch_s'] / off_dist['updates']:.2f} "
          f"ms per ingest on {smi.splitlines()[0]}", flush=True)

    # 16. the other model families: the pixel CNN, the MoE and pp transformers
    zero_flash_counts()
    zero_ring_counts()
    t16 = time.perf_counter()
    pix = pixel_learners(device, root, root / "build" / "chip_smoke_pixel")
    pix_local = pixel_golden_local(device, root, root / "build" / "chip_smoke_pixel_local")
    pix_counts = flash_counts() + ring_counts()
    if any(pix_counts):
        raise AssertionError(f"flash/ring kernels launched on the pixel paths: {pix_counts}")
    ppo, dqn = pix["ppo"], pix["dqn"]
    print(f"[pixel] Nature CNN on make_atari('synthetic') 84x84x4 uint8 frames, f32: "
          f"evaluate of {pix['frames']} frames card vs cpu max abs diff "
          f"{pix['eval_err']:.3e} (tol {TOLERANCE['float32']:g}); PPO's first update on "
          f"[{pix['ppo_rows'][0]}, {pix['ppo_rows'][1]}] card vs cpu: max metric diff "
          f"{ppo['metric_err']:.3e}, max param diff {ppo['param_err']:.3e} (tol "
          f"{MLP_PARAM_ATOL:g}), {ppo['n_floored']} elements below Adam's floor, max diff "
          f"there {ppo['floor_err']:.3e}; pixel DQN (cartpole_dqn golden, uint8 ring of "
          f"{pix['dqn_ring']} frames, {pix['ring_bytes']} B) one update on a batch of "
          f"{pix['dqn_batch']} card vs cpu: max metric diff {dqn['metric_err']:.3e}, max "
          f"param diff {dqn['param_err']:.3e}, {dqn['n_floored']} floored (max "
          f"{dqn['floor_err']:.3e}); flash/ring launches 0", flush=True)
    print(f"[pixel] (not gated) evaluate of {pix['frames']} frames {pix['eval_ms']:.4f} ms; "
          f"PPO update on [{pix['ppo_rows'][0]}, {pix['ppo_rows'][1]}] {pix['ppo_ms']:.2f} ms; "
          f"DQN gradient update {pix['dqn_ms']:.3f} ms; LocalRunner PPO 84x84x4 "
          f"{pix['ppo_steps']} env steps in {pix['ppo_wall']:.2f} s "
          f"({pix['ppo_steps'] / pix['ppo_wall']:.1f} env steps/s, its update included) on "
          f"{smi.splitlines()[0]}", flush=True)
    print(f"[pixel] LocalRunner PPO at the pixel_ppo_catch golden's config (36x36x2): "
          f"{pix_local['updates']} updates, {pix_local['steps']} env steps in "
          f"{pix_local['wall']:.2f} s ({pix_local['steps'] / pix_local['wall']:.1f} env "
          f"steps/s, updates included); (not gated) {pix_local['update_ms']:.2f} ms per "
          f"update on [{pix_local['rows'][0]}, {pix_local['rows'][1]}]; avg return "
          f"{pix_local['avg_return']:.2f} on {smi.splitlines()[0]}", flush=True)
    pix_dist = pixel_server(device, root, root / "build" / "chip_smoke_pixel_dist")
    print(f"[pixel] ppo_pixel36_zmq cell in a chaos_server over ZMQ + VectorAgent "
          f"({PIXEL_LANES} lanes, uint8 frames on the wire: {pix_dist['frames']} frames "
          f"checked, {pix_dist['payload_bytes']:.0f} B per trajectory): "
          f"{pix_dist['updates']} updates, {pix_dist['trajectories']} trajectories "
          f"accepted == max_seq == sent; agent params at version {pix_dist['version']} "
          f"sha256-equal to the publish ({pix_dist['digest'][:16]}); flash/ring launches 0 "
          f"in both processes; (not gated) {pix_dist['steps'] / pix_dist['wall']:.1f} env "
          f"steps/s at the agent on {smi.splitlines()[0]}", flush=True)
    moe = moe_flagship(device, root, root / "build" / "chip_smoke_moe", learned)
    m_decode, b_decode = moe["decode"], moe["decode_bf16"]
    print(f"[moe] transformer_moe_discrete at the flagship's widths ({MOE_ARCH['moe_experts']} "
          f"experts, top-{MOE_ARCH['moe_top_k']}), the plain side's routes pinned to the "
          f"kernels': evaluate kernel vs plain attention max abs diff {moe['eval_err']:.3e} "
          f"(tol {TOLERANCE['bfloat16']:g}; unpinned, {moe['eval_changes']['changed']} of "
          f"{moe['eval_changes']['tokens']} token routes would have changed); first update "
          f"launches (flash_fwd, flash_dq, flash_dkv) {moe['launches']}, max metric diff "
          f"{moe['metric_err']:.3e}, max param diff {moe['param_err']:.3e}, mean param diff "
          f"{moe['mean_diff_share']:.4f} of the mean movement ({moe['update_changes']['changed']} "
          f"of {moe['update_changes']['tokens']} token routes pinned); expert utilization "
          f"{moe['util']}; cached vs window decode over {m_decode['compared']} positions, "
          f"f32: max abs diff logp {m_decode['errs']['logp']:.3e} (tol "
          f"{m_decode['bars']['logp']:.3e}), v {m_decode['errs']['v']:.3e} (tol "
          f"{m_decode['bars']['v']:.3e}), {m_decode['prefills']} prefill, ms per env "
          f"step cached {m_decode['cached_ms']:.3f} vs window {m_decode['window_ms']:.3f}; "
          f"bf16, the cached side's routes pinned to the window's: logp "
          f"{b_decode['errs']['logp']:.3e} (tol {b_decode['bars']['logp']:.3e}), v "
          f"{b_decode['errs']['v']:.3e} (tol {b_decode['bars']['v']:.3e}), "
          f"{b_decode['route_changes']['changed']} of {b_decode['route_changes']['tokens']} "
          f"token routes pinned", flush=True)
    print(f"[moe] recall_moe golden (config.json uncut, dense attention) through "
          f"LocalRunner{' at the second salt (the first stalled)' if moe['golden_stalled'] else ''}"
          f": AverageEpRet {moe['golden_first']:.3f} at update 1, 1.0 at update "
          f"{moe['golden_updates']} ({moe['golden_steps']} env steps in "
          f"{moe['golden_wall']:.2f} s) on {smi.splitlines()[0]}", flush=True)
    pp = pp_flagship(device, root / "build" / "chip_smoke_pp", learned)
    print(f"[pp] transformer_pp_discrete at the flagship's widths: evaluate on "
          f"[{pp['rows'][0]}, {pp['rows'][1]}] bit-equal to transformer_discrete's on the "
          f"same weights stacked; first update launches {pp['launches']}, max metric diff "
          f"{pp['metric_err']:.3e}, max param diff {pp['param_err']:.3e}, mean param diff "
          f"{pp['mean_diff_share']:.4f} of the mean movement", flush=True)
    print(f"[families] phase 16 in {time.perf_counter() - t16:.1f} s", flush=True)
    m_fwd, m_dq, m_dkv = moe["launches"]
    pp_fwd, pp_dq, pp_dkv = pp["launches"]
    fam_fwd = (m_fwd + moe["eval_launches"] + m_decode["launches"] + b_decode["launches"]
               + pp_fwd)

    # 17. the anakin tier: device envs, the fused window as one CUDA graph
    t17 = time.perf_counter()
    env_errs = device_envs_card_vs_cpu(device)
    print(f"[anakin] the six device envs, {ANAKIN_ENV_LANES} lanes x {ANAKIN_ENV_STEPS} "
          f"steps on the card from the cpu's states: integer envs and every integer or "
          f"bool field equal; float fields max diff "
          + ", ".join(f"{k} {v:.3e}" for k, v in env_errs.items() if k in ANAKIN_FLOAT_ENVS)
          + f" (tol {ANAKIN_ENV_TOL:g} x (1 + |x|))", flush=True)
    mlp = anakin_mlp(device, root, root / "build" / "chip_smoke_anakin_mlp")
    mlp_steps = ANAKIN_MLP_LANES * ANAKIN_UNROLL
    print(f"[anakin] cartpole_reinforce_baseline's mlp_discrete "
          f"{'x'.join(map(str, mlp['hidden']))} on device CartPole, {ANAKIN_MLP_LANES} lanes "
          f"x {ANAKIN_UNROLL} steps a window: graph == eager bit for bit, both generators "
          f"advance inside the graph, final_obs == next obs on lanes that go on, "
          f"{mlp['resets']} autoresets inside the reset box, flash/ring launches 0; "
          f"(not gated) {mlp_steps / mlp['graph_ms'] * 1e3:.1f} env steps/s by graph "
          f"({mlp['graph_ms']:.3f} ms a window) vs {mlp_steps / mlp['eager_ms'] * 1e3:.1f} "
          f"eager ({mlp['eager_ms']:.3f} ms) on {smi.splitlines()[0]}", flush=True)
    flag = anakin_flagship(device, root / "build" / "chip_smoke_anakin")
    seq_steps = LANES * ANAKIN_UNROLL
    print(f"[anakin] the flagship on device Recall-v0({HORIZON}, {N_CUES}), {LANES} lanes x "
          f"{ANAKIN_UNROLL} steps a window over a {SLICE_ARCH['max_seq_len']}-row window: "
          f"flash_fwd {flag['per_replay']} per replay (captured) x {flag['replays']} replays "
          f"= {flag['launches']}; graph == eager bit for bit, and after a hot swap "
          f"(sha256 {flag['digest'][:16]}); shipped logp_a vs the plain attention max abs "
          f"diff {flag['logp_err']:.3e} (tol {TOLERANCE['bfloat16']:g}); {flag['frames']} "
          f"columnar frames of {HORIZON} steps decoded; (not gated) "
          f"{seq_steps * flag['replays'] / flag['wall']:.1f} env steps/s through rollout() "
          f"(replay, copy out, columnar emit) beside phase 4's vector tier "
          f"{serve_steps_per_s:.1f}; by graph {seq_steps / flag['graph_ms'] * 1e3:.1f} "
          f"({flag['graph_ms']:.3f} ms a window) vs eager "
          f"{seq_steps / flag['eager_ms'] * 1e3:.1f} ({flag['eager_ms']:.3f} ms) on "
          f"{smi.splitlines()[0]}", flush=True)
    dist17 = anakin_distributed(device, root, root / "build" / "chip_smoke_anakin_dist")
    a_dfwd, a_ddq, a_ddkv = dist17["server_counts"]
    print(f"[anakin] chaos_server (phase 11's learner, {LANES // ANAKIN_UPDATES} episodes an "
          f"epoch) over ZMQ fed by an anakin VectorAgent ({LANES} Recall-v0"
          f"({LEARNER_HORIZON}) lanes, columnar, record_bver): {dist17['updates']} updates, "
          f"server launches {dist17['server_counts']} = {ANAKIN_UPDATES} x "
          f"{dist17['per_update']}; {dist17['frames']:g} columnar frames counted by the "
          f"server; installs {[v for v, _ in dist17['installs']]} sha256-equal to their "
          f"publishes; bver per window {dist17['bvers'][0]} .. {dist17['bvers'][-1]}; agent "
          f"flash_fwd {dist17['agent_launches']} = {flag['per_replay']} x "
          f"{dist17['windows']} replays; (not gated) "
          f"{LANES * ANAKIN_UNROLL * dist17['wave_windows'] / dist17['wall']:.1f} env "
          f"steps/s at the agent over the first wave", flush=True)
    print(f"[anakin] phase 17 in {time.perf_counter() - t17:.1f} s", flush=True)
    anakin_fwd = flag["launches"] + dist17["agent_launches"] + a_dfwd

    # 18. the serving plane: thin clients served by an InferenceService
    t18 = time.perf_counter()
    per_dispatch = (run["launches"] - run["validate_launches"]) // DISPATCHES
    card = smi.splitlines()[0]
    sv = served_flagship(device, root / "build" / "chip_smoke_serving", per_dispatch)
    print(f"[serving] the flagship in a standalone InferenceService (max_batch {LANES}, "
          f"5 ms deadline) over ZMQ to a MultiplexedRemoteClient of {LANES} "
          f"RecallEnv({HORIZON}, {N_CUES}) lanes, {SERVE_STEPS} steps: {sv['dispatches']} "
          f"dispatches, every one replayed through the keyed window step at its bucket "
          f"bit for bit ({sv['checked']} checked); flash_fwd {sv['launches']} = "
          f"{per_dispatch} x {sv['dispatches']}, no flash_dq/flash_dkv; rows per dispatch "
          f"{sv['occupancy']}, buckets {sv['buckets']}; {sv['episodes']} episodes shipped, "
          f"their {sv['compared']} action records equal to the rows served for their "
          f"session and step bit for bit (act, logp_a, v); in flight up to "
          f"{sv['inflight']}", flush=True)
    print(f"[serving] bucket {LANES} rows recomputed at buckets "
          + ", ".join(f"{b}: {c['acts_differ']} actions differ, logp_a max abs diff "
                      f"{c['logp_a']:.3e}, v {c['v']:.3e}" for b, c in sv["cross"].items())
          + f" (tol {TOLERANCE['bfloat16']:g})", flush=True)
    print(f"[serving] (not gated) {sv['requests'] / sv['wall']:.1f} requests/s, "
          f"{1e3 * sv['wall'] / sv['dispatches']:.3f} ms per dispatch end to end (client "
          f"codec, queue, dispatch, reply, env steps), {sv['step_ms']:.3f} ms in the keyed "
          f"window step, device "
          + ("not measured" if sv["device_ms"] is None else f"{sv['device_ms']:.4f} ms")
          + f" per dispatch at bucket {LANES}, on {card}", flush=True)
    print(f"[serving] (not gated) the keyed draw alone at {LANES} rows (median of 50): "
          f"{sv['draw']['build_ms']:.4f} ms to build the per-row Philox generators and "
          f"successor keys, {sv['draw']['draw_ms']:.4f} ms to draw one uniform block and "
          f"copy it to the card, on {card}", flush=True)
    sl = served_learner(device, root / "build" / "chip_smoke_serving_learner", per_dispatch)
    print(f"[serving] TrainingServer(serving=True) with phase 11's learner on the card, "
          f"{SERVE_CLIENTS} thin clients over ZMQ, {DIST_UPDATES} waves of "
          f"RecallEnv({LEARNER_HORIZON}): launches per update {sl['updates']} (expected "
          f"{sl['per_update']} each), served flash_fwd per wave {sl['serve_counts']} = "
          f"{per_dispatch} per dispatch; each wave served at versions "
          f"{sl['wave_versions']}; clients at version {sl['versions'][0]} (the last "
          f"publish); ingest accounting exact; (not gated) "
          f"{sl['steps'] / (sum(sl['wave_s']) / len(sl['wave_s'])):.1f} served env steps/s "
          f"per wave on {card}", flush=True)
    sg = served_grpc(device, root / "build" / "chip_smoke_serving_grpc")
    print(f"[serving] mlp_discrete served over gRPC GetActions (in-band, grpcio) to a "
          f"RemoteActorClient on CartPole-v1: {sg['steps']} actions equal the keyed step "
          f"on the card bit for bit, no flash launch; (not gated) "
          f"{1e3 * sg['wall'] / sg['steps']:.3f} ms per action round trip (local replay "
          f"included) on {card}", flush=True)
    print(f"[serving] phase 18 in {time.perf_counter() - t18:.1f} s", flush=True)
    serving_fwd = sv["launches"] + sum(sl["serve_counts"])
    s_fwd, s_dq, s_dkv = sl["launches"]

    # 19. the RLHF plane: generate with the flagship, score, train IMPALA
    t19 = time.perf_counter()
    rlhf = {}
    for tier, what in (("vector", "a VectorAgent's batched window step over ZMQ"),
                       ("anakin", f"the anakin tier, {RLHF['generation_unroll']}-step windows "
                                  f"captured as one CUDA graph"),
                       ("remote", "thin clients of TrainingServer(serving=True)")):
        t0 = time.perf_counter()
        r = rlhf[tier] = rlhf_plane(device, root / "build" / f"chip_smoke_rlhf_{tier}", tier,
                                    per_dispatch)
        print(f"[rlhf] ({tier}) RlhfScheduler through {what} ({RLHF['lanes']} TokenGen "
              f"lanes, prompt {RLHF['prompt_len']}, up to {RLHF['max_new_tokens']} new tokens) "
              f"against TrainingServer(\"IMPALA\") on the card, {RLHF_FREEZE!r} frozen, the "
              f"reward model (d_model {RLHF['rm_d_model']}, seed {RLHF['rm_seed']}) scoring: "
              f"{r['updates']} updates on {r['episodes']} episodes ({r['gen_lens'][0]}-"
              f"{r['gen_lens'][1]} tokens), every shipped reward equal to the reward model's "
              f"score of its tokens, bver within [0, held], accounting exact, {r['frozen']} "
              f"frozen leaves bit-identical and {r['moved']} others moved, train lag observed "
              f"per trajectory (mean {r['lag']:.3f} versions); launches {r['launches']} = "
              f"{r['generation_k1']} K1 over {r['dispatches']} generation "
              + ("replays" if tier == "anakin" else "dispatches")
              + f" + {r['updates']} x {SLICE_ARCH['n_layers']}/{SLICE_ARCH['n_layers']}/"
              f"{SLICE_ARCH['n_layers']}; (not gated) {r['tokens'] / r['wall']:.1f} tokens/s "
              f"generated, {r['score_ms']:.3f} ms a score batch ({r['score_batches']} batches), "
              f"scores first {[round(x, 4) for x in r['scores'][:8]]} last "
              f"{[round(x, 4) for x in r['scores'][-8:]]}; {time.perf_counter() - t0:.1f} s on "
              f"{card}", flush=True)
    planes = rlhf["vector"]["planes"]
    print(f"[rlhf] the reward model on the card, {planes['rows']} generations one at a time and "
          f"as one batch: score_np == score_batch_np bit for bit (every dispatch "
          f"{RLHF['score_batch']} rows); (not gated) a 1-row forward against the 8-row one: "
          + ("bit-equal" if planes["raw_equal"] else f"max abs diff {planes['raw_diff']:.3e}")
          + f", on {card}", flush=True)
    print(f"[rlhf] phase 19 in {time.perf_counter() - t19:.1f} s", flush=True)
    rlhf_gen = sum(r["generation_k1"] for r in rlhf.values())
    rlhf_learn = sum(r["learner_k1"] for r in rlhf.values())

    # 20. the traced, fleet-aggregated loop; serving and RLHF traced; the profiler
    t20 = time.perf_counter()
    tf = traced_fleet(device, root, root / "build" / "chip_smoke_traced")
    t_fwd, t_dq, t_dkv = tf["server_counts"]
    ta_fwd = tf["agent_counts"][0]
    rep = tf["report"]
    print(f"[traced] chaos_server (trace rate 1, fleet every {FLEET_INTERVAL_S} s) <- "
          f"relay process <- VectorAgent ({DIST_LANES} RecallEnv({LEARNER_HORIZON}) lanes, "
          f"this process), ZMQ: {tf['updates']} updates, server launches {tf['server_counts']}"
          f" = {tf['updates']} x {tf['per_update']}, agent flash_fwd {ta_fwd} = "
          f"{SLICE_ARCH['n_layers'] - 1} x {tf['dispatches']} dispatches; {tf['accepted']} "
          f"accepted trajectories, each traced over {'/'.join(UPSTREAM_HOPS)}; versions "
          f"{tf['versions']} traced over {'/'.join(MODEL_HOPS)}; {tf['spans']} spans from "
          f"three journals joined by the trace CLI; /fleet lists {tf['procs']}, top "
          f"--fleet renders them; {tf['counters_exact']} merged counters equal to the sum "
          f"of the three final registries ({tf['counters_self']} fleet-frame counters "
          f"trail); no alert", flush=True)
    for key, d in rep["per_hop"].items():
        if d["count"] and key.split(":")[0] in ("traj", "model"):
            print(f"[traced] (not gated) {key:<16} n={d['count']:<4} p50 "
                  f"{1e3 * d['p50']:.3f} ms, p95 {1e3 * d['p95']:.3f} ms")
    ages = rep["trajectories"]["data_age_s"], rep["models"]["model_age_s"]
    print(f"[traced] (not gated) data age p50 {1e3 * ages[0]['p50']:.1f} ms, p95 "
          f"{1e3 * ages[0]['p95']:.1f} ms; model age (dispatch to swap) p50 "
          f"{1e3 * ages[1]['p50']:.1f} ms, p95 {1e3 * ages[1]['p95']:.1f} ms; version lag "
          f"mean {rep['trajectories']['data_age_versions']['mean']:.3f}; "
          f"{tf['steps_per_s']:.1f} env steps/s at the agent traced beside phase 11's "
          f"{dist_steps_per_s:.1f} untraced, on {card}", flush=True)
    tsv = served_flagship(device, root / "build" / "chip_smoke_traced_serving",
                          per_dispatch, steps=TRACED_SERVE_STEPS, traced=True)
    print(f"[traced] phase 18 (a) traced, {TRACED_SERVE_STEPS} steps: {tsv['dispatches']} "
          f"dispatches replayed bit for bit ({tsv['checked']} checked), flash_fwd "
          f"{tsv['launches']} = {per_dispatch} x {tsv['dispatches']}; {tsv['serve_traces']} "
          f"serve traces, one per request, each a queue and a dispatch span", flush=True)
    trl = rlhf_plane(device, root / "build" / "chip_smoke_traced_rlhf", "anakin",
                     per_dispatch, updates=TRACED_RLHF_UPDATES, traced=True)
    print(f"[traced] phase 19 (anakin) traced: {trl['updates']} updates on "
          f"{trl['episodes']} episodes, launches {trl['launches']} ({trl['generation_k1']} "
          f"K1 over {trl['dispatches']} replays); rlhf spans' episodes {trl['rlhf_spans']}; "
          f"{trl['rlhf_traces']} episodes traced env to update from {trl['rlhf_stamps']} "
          f"window stamp(s); graph == eager", flush=True)
    pu = profiled_update(learned, root / "build" / "chip_smoke_profile")
    print(f"[traced] utils.profiling.trace around one phase 5 update (annotate "
          f"'chip_smoke_update'): the Chrome trace ({pu['events']} events) lists "
          f"flash_fwd/dq/dkv_bf16_kernel x {pu['found']}, inside the annotated range; the "
          f"wrappers counted {pu['counts']}", flush=True)
    print(f"[traced] phase 20 in {time.perf_counter() - t20:.1f} s", flush=True)
    traced_fwd = t_fwd + ta_fwd + tsv["launches"] + trl["launches"][0] + pu["counts"][0]
    traced_dq = t_dq + trl["launches"][1] + pu["counts"][1]
    traced_dkv = t_dkv + trl["launches"][2] + pu["counts"][2]

    # 21. the mesh learner: pp, ep, fsdp and tp over meshes of the card
    t21 = time.perf_counter()
    phase5_ms = 1e3 * sum(seconds[1:]) / len(seconds[1:])
    mp = mesh_pp(device, root / "build" / "chip_smoke_mesh_pp", learned)
    print(f"[mesh] (a) {PP_ARCH['kind']} under {PP_MESH} ({MESH_SIZE} x the card): "
          f"pipelined evaluate vs unpipelined max abs diff {mp['eval_err']:.3e} (tol "
          f"{TOLERANCE['bfloat16']:g}) at {mp['eval_k1']} K1 = {PP_ARCH['n_layers']} layers x "
          f"{mp['micro']} microbatches x {PP_MESH['dp']} data groups; first update through "
          f"K1-K3 at launches {mp['launches']} (unpipelined {mp['flat_launches']}); vs the "
          f"plain attention: max metric diff {mp['vs_plain']['metric_err']:.3e}, max param "
          f"diff {mp['vs_plain']['param_err']:.3e}, mean {mp['vs_plain']['mean_diff_share']:.4f}"
          f" of the movement; vs the unpipelined update: max metric diff "
          f"{mp['vs_flat']['metric_err']:.3e}, max param diff {mp['vs_flat']['param_err']:.3e},"
          f" mean {mp['vs_flat']['mean_diff_share']:.4f} of the movement; each stage's layers "
          f"and moments on its device; (not gated) {mp['ms']:.2f} ms per update beside phase "
          f"5's {phase5_ms:.2f}"
          + (f", device busy {mp['busy']['busy_ms']:.2f} ms of {mp['busy']['wall_ms']:.2f} "
             f"profiled" if mp["busy"] else "")
          + f"; seconds by step {json.dumps({k: round(v, 2) for k, v in mp['seconds'].items()})}"
          f" on {card}", flush=True)
    mm = mesh_moe(device, root / "build" / "chip_smoke_mesh_moe", learned)
    print(f"[mesh] (b) {MOE_ARCH['kind']} ({MOE_ARCH['moe_experts']} experts, top-"
          f"{MOE_ARCH['moe_top_k']}) under {EP_MESH}: one expert per ep device; first update "
          f"at launches {mm['launches']}; vs the unsharded update: max metric diff "
          f"{mm['vs_flat']['metric_err']:.3e}, max param diff {mm['vs_flat']['param_err']:.3e}, "
          f"mean {mm['vs_flat']['mean_diff_share']:.4f}; vs the plain attention: max metric "
          f"diff {mm['vs_plain']['metric_err']:.3e}, max param diff "
          f"{mm['vs_plain']['param_err']:.3e}, mean {mm['vs_plain']['mean_diff_share']:.4f} "
          f"(routes pinned to the unsharded kernel side's: {mm['changes']['changed']} of "
          f"{mm['changes']['tokens']} token routes would have changed); expert utilization "
          f"{mm['util']}; (not gated) {mm['ms']:.2f} ms per update beside phase 5's "
          f"{phase5_ms:.2f} on {card}", flush=True)
    mf = mesh_fsdp_tp(device, root / "build" / "chip_smoke_mesh_fsdp", learned)
    for name, r in mf.items():
        print(f"[mesh] (c) {name} under {FSDP_TP_MESH}, batch {r['rows']}: first update vs "
              f"the unsharded one " + ("bit-equal" if r["bit_equal"] else
                                       f"max param diff {r['param_err']:.3e}, max metric diff "
                                       f"{r['metric_err']:.3e}")
              + f" (bars rtol {MESH_RTOL:g}, atol {MESH_ATOL:g}); launches {r['launches']}; "
              f"the placed bundle byte-equal to the unplaced; {r['bytes']['shards']} shards; "
              f"bytes per coordinate {json.dumps(r['bytes']['per_coordinate'])}; (not gated) "
              f"{r['ms']:.2f} ms per update beside phase 5's {phase5_ms:.2f} on {card}",
              flush=True)
    me = mesh_entry(device, root / "build" / "chip_smoke_mesh_entry", learned)
    print(f"[mesh] (d) build_algorithm(\"REINFORCE\", model_kind={PP_ARCH['kind']!r}) + "
          f"enable_multihost({PP_MESH}): {MESH_EPOCHS} epochs from receive_trajectory at "
          f"launches {me['per_update']}; a port actor with no mesh served the published bundle "
          f"(version {me['version']}) for {MESH_ACTOR_STEPS} dispatches at {me['served'][0]} K1, "
          f"its params sha256 {me['digest']}... equal to the learner's gathered params and the "
          f"publish snapshot's; (not gated) {[round(x, 2) for x in me['ms']]} ms per update "
          f"(ingest included) beside phase 5's {phase5_ms:.2f} on {card}", flush=True)
    print(f"[mesh] phase 21 in {time.perf_counter() - t21:.1f} s", flush=True)
    # Every counted run of the phase: the sharded updates, their unsharded
    # twins (the fsdp flagship's equals its sharded side's, gated), the
    # entry point's epochs and its actor's dispatches.
    mesh_fwd, mesh_dq, mesh_dkv = (
        mp["launches"][i] + mp["flat_launches"][i] + mm["launches"][i]
        + mm["flat_launches"][i] + 2 * mf["flagship"]["launches"][i]
        + sum(c[i] for c in me["per_update"]) for i in range(3))
    mesh_fwd += mp["eval_k1"] + me["served"][0]

    # 22. the multi-process learner: ranks started here, dp across them
    t22 = time.perf_counter()
    ml = multiprocess_learner(device, root, root / "build" / "chip_smoke_mh", learned)
    for case, r in ml["a"].items():
        print(f"[multiprocess] (a) {case} batch under dp {MH_RANKS} across {MH_RANKS} ranks "
              f"({ml['backend']}, {', '.join(ml['cards'])}): broadcast bit-equal; ranks' params "
              f"sha256 {r['digest']}... equal; launches per rank {r['counts']}; vs one "
              f"process: max metric diff {r['metric_err']:.3e}, max param diff "
              f"{r['param_err']:.3e}, mean {r['mean_diff_share']:.4f} of the movement "
              f"(phase 5's bars); first update {[round(x, 2) for x in r['first_ms']]} ms",
              flush=True)
    ar = ml["allreduce"][0]
    print(f"[multiprocess] (a) (not gated) {[round(x, 2) for x in ml['ms']]} ms per update "
          f"per rank over {MH_TIMED} updates beside phase 5's {phase5_ms:.2f}; one update "
          f"with its all-reduces timed apart: {[round(x, 2) for x in ml['timed_ms']]} ms, of "
          f"which rank 0's {ar['calls']} all-reduces ({ar['bytes']} bytes) took "
          f"{1e3 * ar['s']:.2f} ms (rank 1's {1e3 * ml['allreduce'][1]['s']:.2f}) on {card}",
          flush=True)
    for name, r in ml["c"].items():
        print(f"[multiprocess] (c) {name} (golden widths) under dp {MH_RANKS} across ranks, "
              f"{MH_OFF_UPDATES} updates on the coordinator's samples: networks sha256 "
              f"{r['digest']}... equal; vs one process: max metric diff {r['metric_err']:.3e}, "
              f"max param diff {r['param_err']:.3e} ({r['n_floored']} elements at Adam's "
              f"floor); (not gated) {[round(x, 3) for x in r['ms']]} ms per update over "
              f"{MH_OFF_TIMED} more, each on a broadcast sample", flush=True)
    ms22 = multiprocess_server(device, root, root / "build" / "chip_smoke_mh_server")
    print(f"[multiprocess] (b) a {MH_RANKS}-rank TrainingServer fed by {MH_LANES} agent lanes: "
          f"{MH_SERVER_UPDATES} updates, a collective checkpoint, a resume on every rank, "
          f"{MH_RESUME_UPDATES} more; every version installed by the agent; ranks at version "
          f"{ms22['version']} with params sha256 {ms22['digest']}... equal; launches per rank "
          f"{ms22['counts']}; {ms22['sent']} trajectories sent = accepted = trained (the "
          f"resumed ledger dropped {ms22['replayed']} spool replays); only "
          f"the coordinator bound a transport and published; (not gated) seconds per wave "
          f"(play, train, publish, install) {[round(x, 2) for x in ms22['seconds']]} on {card}",
          flush=True)
    print(f"[multiprocess] phase 22 in {time.perf_counter() - t22:.1f} s", flush=True)
    mh_fwd, mh_dq, mh_dkv = (
        sum(c[i] for r in ml["a"].values() for c in r["counts"])
        + sum(c[i] for part in ms22["counts"] for c in part) for i in range(3))
    mh_fwd += ms22["agent_k1"]

    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "relayrl_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "relayrl_tpu/ops/flash.py:116",
        "launches": (run["launches"] + fwd + r_fwd + decode["launches"] + a_fwd + d_fwd
                     + ga_fwd + g_fwd + fa_fwd + f_fwd + p_fwd + fam_fwd + anakin_fwd
                     + serving_fwd + s_fwd + rlhf_gen + rlhf_learn + traced_fwd + mesh_fwd
                     + mh_fwd),
        "launches_by_path": {"serving": run["launches"], "learner": fwd, "local_loop": r_fwd,
                             "decode_vs_window": decode["launches"],
                             "distributed_agent": a_fwd, "distributed_server": d_fwd,
                             "guardrails_agents": ga_fwd, "guardrails_server": g_fwd,
                             "fleet_agents": fa_fwd, "fleet_server": f_fwd,
                             "ppo_learner": p_fwd, "offpolicy": off_counts[0],
                             "pixel": pix_counts[0] + pix_dist["kernels"]["flash_fwd"],
                             "moe_learner": m_fwd, "moe_evaluate": moe["eval_launches"],
                             "moe_decode_vs_window": m_decode["launches"],
                             "moe_decode_vs_window_bf16": b_decode["launches"],
                             "pp_learner": pp_fwd,
                             "anakin_window_replays": flag["launches"],
                             "anakin_agent_replays": dist17["agent_launches"],
                             "anakin_server": a_dfwd,
                             "serving_plane": serving_fwd,
                             "served_learner": s_fwd,
                             "rlhf_generation": rlhf_gen, "rlhf_learner": rlhf_learn,
                             "traced_fleet_server": t_fwd, "traced_fleet_agent": ta_fwd,
                             "traced_serving": tsv["launches"],
                             "traced_rlhf": trl["launches"][0],
                             "profiled_update": pu["counts"][0],
                             "mesh_learner": mesh_fwd, "multiprocess_learner": mh_fwd},
        **main_flash,
    }, {
        "name": "flash_dq",
        "route": "cuda",
        "source": "relayrl_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "relayrl_tpu/ops/flash.py:223",
        "launches": (dq + r_dq + d_dq + g_dq + f_dq + p_dq + m_dq + pp_dq + a_ddq + s_dq
                     + rlhf_learn + traced_dq + mesh_dq + mh_dq),
        "launches_by_path": {"learner": dq, "local_loop": r_dq, "distributed_server": d_dq,
                             "guardrails_server": g_dq, "fleet_server": f_dq,
                             "ppo_learner": p_dq, "offpolicy": off_counts[1],
                             "pixel": pix_counts[1], "moe_learner": m_dq,
                             "pp_learner": pp_dq, "anakin_server": a_ddq,
                             "served_learner": s_dq, "rlhf_learner": rlhf_learn,
                             "traced_fleet_server": t_dq, "traced_rlhf": trl["launches"][1],
                             "profiled_update": pu["counts"][1], "mesh_learner": mesh_dq,
                             "multiprocess_learner": mh_dq},
        **main_bwd["flash_dq"],
    }, {
        "name": "flash_dkv",
        "route": "cuda",
        "source": "relayrl_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "relayrl_tpu/ops/flash.py:255",
        "launches": (dkv + r_dkv + d_dkv + g_dkv + f_dkv + p_dkv + m_dkv + pp_dkv + a_ddkv
                     + s_dkv + rlhf_learn + traced_dkv + mesh_dkv + mh_dkv),
        "launches_by_path": {"learner": dkv, "local_loop": r_dkv,
                             "distributed_server": d_dkv, "guardrails_server": g_dkv,
                             "fleet_server": f_dkv, "ppo_learner": p_dkv,
                             "offpolicy": off_counts[2], "pixel": pix_counts[2],
                             "moe_learner": m_dkv, "pp_learner": pp_dkv,
                             "anakin_server": a_ddkv, "served_learner": s_dkv,
                             "rlhf_learner": rlhf_learn,
                             "traced_fleet_server": t_dkv, "traced_rlhf": trl["launches"][2],
                             "profiled_update": pu["counts"][2], "mesh_learner": mesh_dkv,
                             "multiprocess_learner": mh_dkv},
        **main_bwd["flash_dkv"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "relayrl_tpu_torch/csrc/ring_flash.cu",
        "replaces": replaces,
        "launches": launches,
        "launches_by_path": {"sp_learner": launches, "offpolicy": off, "pixel": pix},
        **main_ring[name],
    } for name, replaces, launches, off, pix in (
        ("ring_chunk_fwd", "relayrl_tpu/parallel/ring_flash.py:86", ring_fwd, off_counts[3],
         pix_counts[3]),
        ("ring_chunk_dq", "relayrl_tpu/parallel/ring_flash.py:119", ring_dq, off_counts[4],
         pix_counts[4]),
        ("ring_chunk_dkv", "relayrl_tpu/parallel/ring_flash.py:147", ring_dkv,
         off_counts[5], pix_counts[5]))]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def sweep_main(mode: str, first: int, last: int) -> int:
    """``--recall-sweep FIRST LAST``: :func:`recall_sweep` over salts
    ``FIRST .. LAST - 1`` on the card, after the kernels' build;
    ``--moe-golden-sweep FIRST LAST``: :func:`moe_golden_sweep` over
    them, each run capped at ``MOE_GOLDEN_SWEEP_UPDATES``."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip(), flush=True)
    root = Path(__file__).resolve().parent
    device = torch.device("cuda")
    if mode == "--moe-golden-sweep":
        return moe_golden_sweep(device, root, root / "build" / "chip_smoke_moe_sweep",
                                range(first, last), MOE_GOLDEN_SWEEP_UPDATES)
    from relayrl_tpu_torch import _kernels

    _kernels.build()
    return recall_sweep(device, root / "build" / "chip_smoke_recall_sweep",
                        range(first, last))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mh-rank"]:
        sys.exit(mh_rank_main(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])))
    if sys.argv[1:2] == ["--nccl-shared-card-probe"]:
        sys.exit(nccl_shared_card_probe(int(sys.argv[2]), int(sys.argv[3])))
    if sys.argv[1:2] in (["--recall-sweep"], ["--moe-golden-sweep"]):
        sys.exit(sweep_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3])))
    sys.exit(main())
