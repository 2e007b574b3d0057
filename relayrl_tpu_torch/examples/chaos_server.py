"""Killable/restartable TrainingServer worker for crash drills.

Twin of ``benches/_chaos_server.py`` on the port. A coordinator spawns this
process, SIGKILLs it mid-run (the learner crash drill), then respawns it
with ``"resume": true``: the checkpoint restores the full train state and
the ingest-ledger sidecar restores the dedup state consistent with the
restored params. Run it as::

    python -m relayrl_tpu_torch.examples.chaos_server '<json-config>'

with keys::

    algorithm, obs_dim, act_dim, hyperparams   — TrainingServer ctor
    device           — torch device (default: the GPU)
    server_type + addr overrides               — transport plane
    scratch          — working dir (config/checkpoints/status live here)
    checkpoint_every — learner.checkpoint_every_epochs
    dedup_window     — learner.ingest_dedup_window
    config           — extra config sections, merged over the defaults
                       written here (guardrails are always off: the port
                       does not have them)
    resume           — restore from scratch/checkpoints before serving
    digests          — add the published params' sha256 to the status
    status_path      — JSON status file, atomically rewritten ~3x/s:
                       {pid, t, version, stats, accounting, registered,
                        kernels, resume, publish_bytes, timings,
                        telemetry[, published]}
    run_s            — optional auto-exit

``kernels`` holds the flash kernels' launch counts in this process
(``flash_fwd``, ``flash_dq``, ``flash_dkv``); ``resume`` the restored
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


def write_config(cfg: dict) -> str:
    """The scratch-local config: pins the checkpoint plane and telemetry so
    a restarted process resumes from exactly what the dead one wrote."""
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


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    cfg = json.loads(argv[0])
    config_path = write_config(cfg)

    from relayrl_tpu_torch import telemetry
    from relayrl_tpu_torch.ops.flash import flash_attention
    from relayrl_tpu_torch.runtime.server import TrainingServer

    addr_keys = ("agent_listener_addr", "trajectory_addr", "model_pub_addr")
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
    server.enable_server()
    server.wait_warmup(timeout=180)

    status_path = cfg["status_path"]
    digests = bool(cfg.get("digests", False))
    stop = threading.Event()

    def status_loop() -> None:
        while not stop.is_set():
            try:
                status = {
                    "pid": os.getpid(),
                    "t": time.time(),
                    "version": int(server.latest_model_version),
                    "stats": dict(server.stats),
                    "last_learner_error": server.last_learner_error,
                    "accounting": server.ingest_accounting(),
                    "registered": len(server.agent_ids),
                    "kernels": {
                        "flash_fwd": flash_attention.launches,
                        "flash_dq": flash_attention.dq_launches,
                        "flash_dkv": flash_attention.dkv_launches},
                    "resume": resumed,
                    "publish_bytes": {k: list(v) for k, v in
                                      server.publish_bytes.items()},
                    "timings": dict(server.timings),
                    "telemetry": telemetry.get_registry().snapshot(),
                }
                if digests:
                    got = server.published_digest()
                    status["published"] = (None if got is None else
                                           {"version": got[0],
                                            "digest": got[1]})
                _write_status(status_path, status)
            except Exception as e:  # a status hiccup must not kill serving
                print(f"[chaos-server] status write failed: {e!r}",
                      flush=True)
            stop.wait(0.3)

    t = threading.Thread(target=status_loop, daemon=True)
    t.start()
    print(f"[chaos-server] serving (pid={os.getpid()}, "
          f"resume={cfg.get('resume', False)}, device={server.device})",
          flush=True)
    deadline = (time.time() + float(cfg["run_s"])
                if cfg.get("run_s") else None)
    try:
        while deadline is None or time.time() < deadline:
            time.sleep(0.2)
    finally:
        stop.set()
        server.disable_server()


if __name__ == "__main__":
    main()
