"""Killable/restartable TrainingServer worker for crash drills.

Twin of ``benches/_chaos_server.py`` on the port. A coordinator spawns this
process, SIGKILLs it mid-run (the learner crash drill), then respawns it
with ``"resume": true``: the checkpoint restores the full train state and
the ingest-ledger sidecar restores the dedup state consistent with the
restored params. Run it as::

    python -m relayrl_tpu_torch.examples.chaos_server [--no-guardrails] \
        '<json-config>'

with keys::

    algorithm, obs_dim, act_dim, hyperparams   — TrainingServer ctor
                       (algorithm: any registered one)
    device           — torch device (default: the GPU)
    local_device_ids — a rank's cards (``initialize_distributed``'s
                       ``local_device_ids``, as ``jax.distributed``'s):
                       its mesh devices; one card named twice, ``[0,
                       0]``, gives a rank two shards of an sp ring on it
    server_type + addr overrides               — transport plane (zmq:
                       agent_listener_addr, trajectory_addr,
                       model_pub_addr; grpc and native: bind_addr;
                       native_grpc: false pins grpc to grpcio, the plane
                       with typed nacks)
    scratch          — working dir (config/checkpoints/status live here)
    checkpoint_every — learner.checkpoint_every_epochs
    dedup_window     — learner.ingest_dedup_window
    config           — extra config sections, merged over the defaults
                       written here
    resume           — restore from scratch/checkpoints before serving
    digests          — add the published params' sha256 to the status,
                       the latest (``published``) and every version's
                       (``published_log``: {version: sha256})
    state_digests    — after every update, on every rank, log the
                       params' sha256 (``state_log``: {version: sha256};
                       one device sync an update)
    status_path      — JSON status file, atomically rewritten ~3x/s:
                       {pid, t, version, algo_version, distributed, stats,
                        accounting, registered, kernels, ring (the sp
                        ring's hops and gathers: count, bytes, seconds),
                        resume,
                        publish_bytes, last_publish, timings, guardrails,
                        probes_disabled, telemetry, exporter, transport,
                        decoded_by[, published, published_log][,
                        state_log][, rolled_back]}
    run_s            — optional auto-exit
    stop_path        — optional: the server shuts down cleanly once this
                       file exists, then writes one last status with
                       ``final: true``: the registry snapshot taken after
                       the shutdown and one closing fleet tick, ``state``
                       (the train state's fingerprint, as ``resume``), and (with
                       ``telemetry.fleet_interval_s > 0``) ``fleet``, the
                       root's ``/fleet`` document at that point
    profile          — optional {"after": a, "updates": n, "path": p}: once
                       the server has made ``a`` updates, profile the next
                       ``n`` (torch.profiler on the device, the learner
                       thread's CPU clock and run-queue wait) and write a
                       JSON summary to ``p`` (see ``profile_learner``)

With ``RELAYRL_COORDINATOR``, ``RELAYRL_NUM_PROCESSES`` and
``RELAYRL_PROCESS_ID`` in its environment the process is one rank of a
multi-process learner (the ``TrainingServer``'s multi-host mode): start one
per rank with the same config (its ``checkpoint_dir`` shared); only rank
0 binds the transport and publishes. ``version`` is the latest published
version (rank 0's), ``algo_version`` every rank's own model version, and
``distributed`` the server's ``distributed_info``.

The training-health guardrails run as the config says (on by default, as
in the reference); ``--no-guardrails`` turns them off. ``guardrails`` in
the status is the server's ``guardrails_accounting()``; after each
rollback, ``rolled_back`` holds the restored train state's fingerprint
(version, params digest and Adam step counts), read once when the
rollback count changes.

``telemetry`` is the registry's snapshot and ``exporter`` the URL of its
``/metrics`` exporter (None without one). ``kernels`` holds the flash and
ring kernels' launch counts in this
process (``flash_fwd``, ``flash_dq``, ``flash_dkv``, ``ring_chunk_fwd``,
``ring_chunk_dq``, ``ring_chunk_dkv``); ``transport`` the server
transport's class; ``decoded_by`` which decoder took each trajectory
(``TrainingServer.decoded_by``); ``resume`` the restored
version, params digest and Adam step counts, read before the server
starts. SIGTERM runs the server's own signal path (final checkpoint +
ledger sidecar + clean shutdown); SIGKILL is the drill.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time


def _write_status(path: str, payload: dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def _merge(base: dict, extra: dict) -> dict:
    out = dict(base)
    for key, value in extra.items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = _merge(out[key], value)
        else:
            out[key] = value
    return out


def write_config(cfg: dict, guardrails: bool = True) -> str:
    """The scratch-local config: pins the checkpoint plane and telemetry so
    a restarted process resumes from exactly what the dead one wrote.
    ``guardrails=False`` (the ``--no-guardrails`` flag) turns them off."""
    scratch = cfg["scratch"]
    os.makedirs(scratch, exist_ok=True)
    config_path = os.path.join(scratch, "chaos_server_config.json")
    if not os.path.exists(config_path):
        base = {
            "learner": {
                "checkpoint_dir": os.path.join(scratch, "checkpoints"),
                "checkpoint_every_epochs": int(cfg.get("checkpoint_every", 2)),
                "ingest_dedup_window": int(cfg.get("dedup_window", 4096)),
            },
            "telemetry": {"enabled": True, "port": 0},
        }
        config = _merge(base, cfg.get("config") or {})
        if not guardrails:
            config = _merge(config, {"guardrails": {"enabled": False}})
        tmp = f"{config_path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(config, f)
        os.replace(tmp, config_path)
    return config_path


def resume_info(algo) -> dict:
    """The restored state's fingerprint: version, params digest and every
    optimizer's Adam step counts."""
    from relayrl_tpu_torch.checkpoint.manager import (
        capture_state,
        train_state_digest,
    )

    return {"version": int(algo.version),
            **train_state_digest(capture_state(algo.state))}


def _thread_clocks(thread: threading.Thread) -> dict:
    """One thread's CPU seconds (its POSIX CPU-time clock) and, where
    Linux's ``/proc/self/task/<tid>/schedstat`` exists, its seconds spent
    waiting on a run queue for a core."""
    out = {}
    try:
        out["cpu_s"] = time.clock_gettime(
            time.pthread_getcpuclockid(thread.ident))
    except (AttributeError, OSError, TypeError):
        pass
    try:
        with open(f"/proc/self/task/{thread.native_id}/schedstat") as f:
            out["runqueue_s"] = int(f.read().split()[1]) / 1e9
    except (OSError, ValueError, IndexError, AttributeError):
        pass
    return out


def profile_learner(server, after: int, updates: int, path: str,
                    stop: threading.Event) -> None:
    """Profile the learner from its ``after``-th update to its
    ``after + updates``-th, and write per-update numbers to ``path``: the learner thread's wall,
    CPU and run-queue wait seconds and its ``timings`` deltas (dispatch,
    fence, idle), and the device busy ms and operations of every kernel
    this process ran in the window (torch.profiler; CUDA activity is
    recorded for the whole process). The question it answers: is a
    learner beside an agent slower on the host (CPU time), in the queue
    for a core (run-queue wait, where the kernel reports it), or on the
    device (kernel time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def updates_done():
        return server.stats["updates"]

    while updates_done() < after and not stop.is_set():
        time.sleep(0.01)
    learner = server._learner_thread
    t0, timings0 = time.monotonic(), dict(server.timings)
    clocks0 = _thread_clocks(learner)
    start = updates_done()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        while updates_done() < after + updates and not stop.is_set():
            time.sleep(0.01)
        if server.device.type == "cuda":
            torch.cuda.synchronize(server.device)
    wall = time.monotonic() - t0
    done = updates_done() - start
    clocks1 = _thread_clocks(learner)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in kernels)
    per = max(done, 1)
    summary = {
        "updates": done, "wall_ms": 1e3 * wall / per,
        "timings_ms": {k: 1e3 * (server.timings[k] - timings0.get(k, 0.0))
                       / per for k in server.timings},
        "device_busy_ms": (busy_us / 1e3 / per) if busy_us > 0 else None,
        "device_operations": sum(e.count for e in kernels) / per,
        "top_kernels": [[e.key[:90], e.self_device_time_total / 1e3 / per,
                         e.count / per] for e in sorted(
            kernels, key=lambda e: -e.self_device_time_total)[:8]],
    }
    for key, name in (("cpu_s", "learner_cpu_ms"),
                      ("runqueue_s", "learner_runqueue_ms")):
        if key in clocks0 and key in clocks1:
            summary[name] = 1e3 * (clocks1[key] - clocks0[key]) / per
    _write_status(path, summary)


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    guardrails = "--no-guardrails" not in argv
    cfg = json.loads([a for a in argv if a != "--no-guardrails"][0])
    config_path = write_config(cfg, guardrails=guardrails)

    from relayrl_tpu_torch import telemetry
    from relayrl_tpu_torch.ops.flash import flash_attention
    from relayrl_tpu_torch.parallel import initialize_distributed, ring, ring_flash
    from relayrl_tpu_torch.runtime.server import TrainingServer

    if cfg.get("local_device_ids") is not None:
        # Before the server's own call, which then returns this topology.
        initialize_distributed(local_device_ids=cfg["local_device_ids"])

    addr_keys = ("agent_listener_addr", "trajectory_addr", "model_pub_addr",
                 "bind_addr", "native_grpc")
    addrs = {k: cfg[k] for k in addr_keys if k in cfg}
    server = TrainingServer(
        cfg.get("algorithm", "REINFORCE"),
        obs_dim=int(cfg.get("obs_dim", 8)),
        act_dim=int(cfg.get("act_dim", 4)),
        env_dir=cfg["scratch"],
        config_path=config_path,
        hyperparams=cfg.get("hyperparams") or {},
        server_type=cfg.get("server_type", "zmq"),
        resume=bool(cfg.get("resume", False)),
        handle_signals=True,
        start=False,
        device=cfg.get("device"),
        **addrs,
    )
    resumed = resume_info(server.algorithm)
    digests = bool(cfg.get("digests", False))
    published_log: dict[int, str] = {}
    if digests:
        from relayrl_tpu_torch.weights import tree_digest

        publish = server._publish_params

        def publish_and_log(version, arch, host_params):
            # Logged before the broadcast: a status that shows this version
            # published, or an agent that installed it, finds its digest.
            published_log[int(version)] = tree_digest(host_params)
            publish(version, arch, host_params)

        server._publish_params = publish_and_log
    state_log: dict[int, str] = {}
    if cfg.get("state_digests"):
        from relayrl_tpu_torch.weights import params_to_jax, tree_digest

        algo, train = server.algorithm, server.algorithm.train_on_batch

        def train_and_digest(batch):
            out = train(batch)
            state_log[int(algo.version)] = tree_digest(params_to_jax(algo.state.params))
            return out

        algo.train_on_batch = train_and_digest
    server.enable_server()
    server.wait_warmup(timeout=180)

    status_path = cfg["status_path"]
    stop = threading.Event()
    rolled_back = {"count": 0, "state": None}

    def build_status() -> dict:
        guard = server.guardrails_accounting()
        if guard.get("rollbacks_total", 0) != rolled_back["count"]:
            rolled_back["count"] = guard["rollbacks_total"]
            rolled_back["state"] = resume_info(server.algorithm)
        status = {
            "pid": os.getpid(),
            "t": time.time(),
            "version": int(server.latest_model_version),
            "algo_version": int(server.algorithm.version),
            "distributed": dict(server.distributed_info),
            "stats": dict(server.stats),
            "last_learner_error": server.last_learner_error,
            "accounting": server.ingest_accounting(),
            "registered": len(server.agent_ids),
            "kernels": {
                "flash_fwd": flash_attention.launches,
                "flash_dq": flash_attention.dq_launches,
                "flash_dkv": flash_attention.dkv_launches,
                "ring_chunk_fwd": ring_flash.chunk_fwd.launches,
                "ring_chunk_dq": ring_flash.chunk_dq.launches,
                "ring_chunk_dkv": ring_flash.chunk_dkv.launches},
            "ring": ring.COMM.as_dict(),
            "resume": resumed,
            "publish_bytes": {k: list(v) for k, v in
                              server.publish_bytes.items()},
            "last_publish": server.last_publish,
            "timings": dict(server.timings),
            "transport": type(server.transport).__name__,
            "decoded_by": dict(server.decoded_by),
            "guardrails": guard,
            # 1 when the probes disabled themselves after a failure (the
            # guardrails attach them when enabled).
            "probes_disabled": int(
                server.guardrails is not None
                and server.guardrails.params["probes"]
                and server.guardrails.watchdog is not None
                and server.algorithm._guard_probes is None),
            "telemetry": telemetry.get_registry().snapshot(),
            "exporter": (None if server._exporter is None
                         else server._exporter.url),
        }
        if rolled_back["state"] is not None:
            status["rolled_back"] = rolled_back["state"]
        if digests:
            got = server.published_digest()
            status["published"] = (None if got is None else
                                   {"version": got[0], "digest": got[1]})
            status["published_log"] = dict(published_log)
        if cfg.get("state_digests"):
            status["state_log"] = dict(state_log)
        return status

    def status_loop() -> None:
        while not stop.is_set():
            try:
                _write_status(status_path, build_status())
            except Exception as e:  # a status hiccup must not kill serving
                print(f"[chaos-server] status write failed: {e!r}",
                      flush=True)
            stop.wait(0.3)

    t = threading.Thread(target=status_loop, daemon=True)
    t.start()
    if cfg.get("profile"):
        prof_cfg = cfg["profile"]
        threading.Thread(
            target=profile_learner, daemon=True,
            args=(server, int(prof_cfg.get("after", 1)),
                  int(prof_cfg.get("updates", 1)), prof_cfg["path"],
                  stop)).start()
    print(f"[chaos-server] serving (pid={os.getpid()}, "
          f"resume={cfg.get('resume', False)}, device={server.device})",
          flush=True)
    deadline = (time.time() + float(cfg["run_s"])
                if cfg.get("run_s") else None)
    stop_path = cfg.get("stop_path")
    try:
        while deadline is None or time.time() < deadline:
            if stop_path and os.path.exists(stop_path):
                break
            time.sleep(0.2)
    finally:
        stop.set()
        t.join(timeout=5)
        server.disable_server()
    # A clean stop: the last status holds the registry as this process
    # ends, after one closing fleet tick, beside the fleet document that
    # tick left (what the root's /fleet serves).
    if server._fleet is not None:
        server._fleet_tick()
    status = build_status()
    status["final"] = True
    status["state"] = resume_info(server.algorithm)
    if server._fleet is not None:
        status["fleet"] = server._fleet.document(alerts=server._alerts)
    _write_status(status_path, status)


if __name__ == "__main__":
    main()
