"""JSON config loader.

A copy of :mod:`relayrl_tpu.config.loader` with its imports pointed at the
port (``learner.freeze`` validates through
:mod:`relayrl_tpu_torch.algorithms.freeze`).

Capability parity with the reference's ``ConfigLoader``
(reference: relayrl_framework/src/sys_utils/config_loader.rs:229-555 and the
auto-create macros at :30-58): loads `relayrl_config.json`, auto-creates it
from the embedded default when missing, exposes per-algorithm hyperparams,
three endpoint addresses, tensorboard params, model paths and
max_traj_length, with hardcoded fallbacks when keys are absent.

Departures (SURVEY.md §7.5):
* ``grpc_idle_timeout_s`` is seconds and used as seconds — the reference's
  config says 30 (seconds) but feeds it to a millisecond timeout
  (default_config.json:15 vs training_grpc.rs:757).
* client/server model-path fallbacks are not swapped
  (config_loader.rs:504-534 returns them crossed).
* auto-create is opt-out via ``create_if_missing=False`` for processes that
  must not write to cwd.
"""

from __future__ import annotations

import copy
import json
import os
from pathlib import Path
from typing import Any, Mapping

from relayrl_tpu_torch.config.default_config import (
    DEFAULT_CONFIG,
    SUPPORTED_ALGORITHMS,
    default_config,
)

DEFAULT_CONFIG_FILENAME = "relayrl_config.json"

#: (config_path, dotted_key) pairs already warned about — unknown-key
#: warnings fire once per process per file, not once per ConfigLoader
#: (a server + N agents in one process would otherwise repeat them).
_warned_unknown_keys: set[tuple[str, str]] = set()


def _closest(key: str, candidates) -> str | None:
    """Nearest known key for the typo hint, or None when nothing close."""
    import difflib

    matches = difflib.get_close_matches(key, [str(c) for c in candidates],
                                        n=1, cutoff=0.6)
    return matches[0] if matches else None


class Endpoint:
    """One server address `{prefix, host, port}`
    (ref schema: config_loader.rs:161-179)."""

    def __init__(self, prefix: str = "tcp://", host: str = "127.0.0.1", port: str | int = "0"):
        self.prefix = prefix
        self.host = host
        self.port = str(port)

    @property
    def address(self) -> str:
        return f"{self.prefix}{self.host}:{self.port}"

    @property
    def host_port(self) -> str:
        return f"{self.host}:{self.port}"

    def __repr__(self) -> str:
        return f"Endpoint({self.address!r})"

    @classmethod
    def from_dict(cls, d: Mapping[str, Any], fallback: "Endpoint") -> "Endpoint":
        return cls(
            prefix=str(d.get("prefix", fallback.prefix)),
            host=str(d.get("host", fallback.host)),
            port=str(d.get("port", fallback.port)),
        )


_FALLBACK_ENDPOINTS = {
    "training_server": Endpoint(port="50051"),
    "trajectory_server": Endpoint(port="7776"),
    "agent_listener": Endpoint(port="7777"),
    "inference_server": Endpoint(port="7778"),
}


class ConfigLoader:
    """Load + query the framework config (ref: ConfigLoader::new + getters,
    config_loader.rs:241-297, 344-381)."""

    def __init__(
        self,
        algorithm_name: str | None = None,
        config_path: str | os.PathLike | None = None,
        create_if_missing: bool = True,
    ):
        self.config_path = resolve_config_path(config_path, create_if_missing)
        self.algorithm_name = algorithm_name
        if self.config_path is not None and Path(self.config_path).is_file():
            with open(self.config_path, "r") as f:
                loaded = json.load(f)
                # A non-object root (null / list / scalar — valid JSON,
                # malformed config) must degrade to defaults like every
                # other malformed section, not crash the first getter.
                if isinstance(loaded, dict):
                    self._raw = loaded
                else:
                    import warnings

                    warnings.warn(
                        f"config root is {type(loaded).__name__}, not an "
                        "object; using built-in defaults")
                    self._raw = default_config()
        else:
            self._raw = default_config()
        self._warn_unknown_keys()
        if algorithm_name is not None and algorithm_name.upper() not in SUPPORTED_ALGORITHMS:
            # The reference whitelists but ultimately tolerates unknown algos
            # (they resolve to empty params); keep that permissiveness for
            # user plugin algorithms, just warn.
            import warnings

            warnings.warn(
                f"algorithm {algorithm_name!r} is not in the built-in registry "
                f"{SUPPORTED_ALGORITHMS}; treating as a plugin"
            )

    def _warn_unknown_keys(self) -> None:
        """Warn ONCE per (config file, key) about keys the framework will
        never read: unknown top-level sections (the classic typo'd
        ``guardrials:`` block — silently ignored until this check) and
        unknown keys inside the known non-algorithm sections. Unknown
        ALGORITHM hyperparams are deliberately exempt (plugin algorithms
        take arbitrary overrides); ``_comment*`` keys are the config
        file's documented escape hatch."""
        import warnings

        def warn(key: str, hint: str) -> None:
            marker = (str(self.config_path), key)
            if marker in _warned_unknown_keys:
                return
            _warned_unknown_keys.add(marker)
            warnings.warn(f"config key {key!r} is not recognized and will "
                          f"be ignored{hint}", stacklevel=4)

        known_top = set(DEFAULT_CONFIG) | {"grpc_idle_timeout_s",
                                           "grpc_idle_timeout",
                                           "max_traj_length"}
        for key in self._raw:
            if str(key).startswith("_comment"):
                continue
            if key not in known_top:
                close = _closest(str(key), known_top)
                warn(str(key), f" (did you mean {close!r}?)" if close else "")
        # Sections whose key set IS the contract (algorithms excluded:
        # hyperparam overrides are open-ended by design).
        for section in ("actor", "transport", "learner", "telemetry",
                        "guardrails", "serving", "relay", "rlhf",
                        "model_paths", "server", "training_tensorboard"):
            defaults = DEFAULT_CONFIG.get(section)
            loaded = self._section(section)
            if not isinstance(defaults, Mapping) or not loaded:
                continue
            for key in loaded:
                if str(key).startswith("_comment") or key in defaults:
                    continue
                close = _closest(str(key), set(defaults))
                warn(f"{section}.{key}",
                     f" (did you mean {section}.{close!r}?)" if close
                     else "")

    # -- getters (ref: config_loader.rs:344-555) --
    def _section(self, key: str) -> Mapping:
        """A top-level config section, or {} when absent OR malformed
        (null / list / scalar): every getter must degrade to defaults, not
        crash the server on a hand-edited file (the reference's getters
        all fall back — config_loader.rs:344-381)."""
        value = self._raw.get(key)
        return value if isinstance(value, Mapping) else {}

    def get_algorithm_params(self, algorithm_name: str | None = None) -> dict[str, Any]:
        name = algorithm_name or self.algorithm_name
        if name is None:
            return {}
        algos = self._section("algorithms")
        # case-insensitive lookup, defaults merged under user overrides
        defaults = DEFAULT_CONFIG["algorithms"]
        base = {}
        for k, v in defaults.items():
            if k.upper() == name.upper():
                base = copy.deepcopy(v)  # nested lists must not alias defaults
        for k, v in algos.items():
            if str(k).upper() == name.upper() and isinstance(v, Mapping):
                base.update(v)
        return base

    def _endpoint(self, key: str) -> Endpoint:
        fallback = _FALLBACK_ENDPOINTS[key]
        entry = self._section("server").get(key)
        if not isinstance(entry, Mapping):
            return fallback
        return Endpoint.from_dict(entry, fallback)

    def get_train_server(self) -> Endpoint:
        return self._endpoint("training_server")

    def get_traj_server(self) -> Endpoint:
        return self._endpoint("trajectory_server")

    def get_agent_listener(self) -> Endpoint:
        return self._endpoint("agent_listener")

    def get_inference_server(self) -> Endpoint:
        """Serving-plane action channel (zmq ROUTER/DEALER — the thin
        clients' request/response endpoint; grpc fleets use the in-band
        GetActions RPC on training_server instead)."""
        return self._endpoint("inference_server")

    def get_tb_params(self) -> dict[str, Any]:
        params = dict(DEFAULT_CONFIG["training_tensorboard"])
        params.update(self._section("training_tensorboard"))
        params.pop("_comment1", None)
        params.pop("_comment2", None)
        return params

    def get_client_model_path(self) -> str:
        return str(
            self._section("model_paths").get("client_model", "client_model.rlx")
        )

    def get_server_model_path(self) -> str:
        return str(
            self._section("model_paths").get("server_model", "server_model.rlx")
        )

    def get_max_traj_length(self) -> int:
        try:
            value = int(self._raw.get("max_traj_length", 1000))
        except (TypeError, ValueError):
            return 1000
        return value if value >= 1 else 1000

    def get_grpc_idle_timeout_s(self) -> float:
        # torchlint: disable=CFG01 - legacy spelling kept readable for old config files
        raw = self._raw.get("grpc_idle_timeout_s", self._raw.get("grpc_idle_timeout", 30.0))
        try:
            value = float(raw)
        except (TypeError, ValueError):
            return 30.0
        return value if value > 0 else 30.0

    def get_learner_params(self) -> dict[str, Any]:
        params = {k: (dict(v) if isinstance(v, dict) else v)
                  for k, v in DEFAULT_CONFIG["learner"].items()}
        params.update(self._section("learner"))
        # learner.freeze validates at LOAD time (the unknown-key warning
        # convention's validate-early cousin): a typo'd regex must fail
        # the config read with the offending pattern named, not the Nth
        # training step — and a malformed value degrades to no freezing
        # with a warning rather than crashing server construction.
        freeze = params.get("freeze")
        if freeze is not None:
            from relayrl_tpu_torch.algorithms.freeze import normalize_freeze_spec

            try:
                params["freeze"] = list(normalize_freeze_spec(freeze)) or None
            except ValueError as e:
                import warnings

                warnings.warn(f"ignoring invalid learner.freeze: {e}")
                params["freeze"] = None
        return params

    def get_actor_params(self) -> dict[str, Any]:
        """Actor-plane knobs (``actor.num_envs`` / ``actor.host_mode`` /
        the anakin pair ``actor.unroll_length`` + ``actor.jax_env``),
        defaults merged under user overrides like every other section —
        malformed values degrade to the one-env-per-process default."""
        params = dict(DEFAULT_CONFIG["actor"])
        params.update(self._section("actor"))
        try:
            params["num_envs"] = max(1, int(params.get("num_envs", 1)))
        except (TypeError, ValueError):
            params["num_envs"] = 1
        if params.get("host_mode") not in ("process", "vector", "anakin",
                                           "remote"):
            params["host_mode"] = "process"
        try:
            params["unroll_length"] = max(1, int(
                params.get("unroll_length", 32)))
        except (TypeError, ValueError):
            params["unroll_length"] = 32
        jax_env = params.get("jax_env")
        params["jax_env"] = (str(jax_env) if jax_env
                             else DEFAULT_CONFIG["actor"]["jax_env"])
        # window_size: None defers to the model's serving context
        # (resolve_actor_context); an explicit value narrows the rolling
        # window and is clamped to >= 1. The hosts clamp it to the model
        # context again at build time — config cannot widen past it.
        ws = params.get("window_size")
        if ws is not None:
            try:
                ws = max(1, int(ws))
            except (TypeError, ValueError):
                ws = None
        params["window_size"] = ws
        params["async_emit"] = bool(params.get("async_emit", False))
        try:
            params["emit_coalesce_frames"] = max(1, int(
                params.get("emit_coalesce_frames", 1)))
        except (TypeError, ValueError):
            params["emit_coalesce_frames"] = 1
        # columnar_wire: "auto" resolves per tier (anakin -> columnar
        # frames, host-bound tiers -> per-record); booleans force it.
        cw = params.get("columnar_wire", "auto")
        if not isinstance(cw, bool):
            cw = "auto"
        params["columnar_wire"] = cw
        try:
            # 0 legitimately disables the spool; negatives clamp to 0.
            params["spool_entries"] = max(0, int(
                params.get("spool_entries", 512)))
        except (TypeError, ValueError):
            params["spool_entries"] = 512
        try:
            params["spool_bytes"] = max(1 << 16, int(
                params.get("spool_bytes", 64 << 20)))
        except (TypeError, ValueError):
            params["spool_bytes"] = 64 << 20
        spool_dir = params.get("spool_dir")
        params["spool_dir"] = str(spool_dir) if spool_dir else None
        return params

    def get_transport_params(self) -> dict[str, Any]:
        """Transport-plane knobs (``transport.heartbeat_s`` plus the
        model-wire v2 set ``wire_version`` / ``keyframe_interval`` /
        ``compress`` / ``chunk_bytes``), defaults merged under user
        overrides; malformed values degrade to the built-ins rather
        than crashing transport construction."""
        params = dict(DEFAULT_CONFIG["transport"])
        params.update(self._section("transport"))
        try:
            params["heartbeat_s"] = float(params.get("heartbeat_s", 5.0))
        except (TypeError, ValueError):
            params["heartbeat_s"] = 5.0
        try:
            params["wire_version"] = int(params.get("wire_version", 2))
        except (TypeError, ValueError):
            params["wire_version"] = 2
        if params["wire_version"] not in (1, 2):
            params["wire_version"] = 2
        try:
            # >= 1: an interval that never keyframed would make the
            # first dropped delta a permanent broadcast blackout.
            params["keyframe_interval"] = max(
                1, int(params.get("keyframe_interval", 10)))
        except (TypeError, ValueError):
            params["keyframe_interval"] = 10
        try:
            params["chunk_bytes"] = max(0, int(params.get("chunk_bytes", 0)))
        except (TypeError, ValueError):
            params["chunk_bytes"] = 0
        try:
            smb = params.get("small_model_bytes")
            params["small_model_bytes"] = (None if smb is None
                                           else max(0, int(smb)))
        except (TypeError, ValueError):
            params["small_model_bytes"] = None
        try:
            params["resync_min_interval_s"] = max(0.0, float(
                params.get("resync_min_interval_s", 0.25)))
        except (TypeError, ValueError):
            params["resync_min_interval_s"] = 0.25
        # retry: keep the raw (merged) dict — RetryPolicy.from_dict and
        # retry.breaker_from_config own per-knob validation, so a
        # malformed knob degrades at the consumer with the same
        # defaults everywhere.
        retry = params.get("retry")
        defaults = dict(DEFAULT_CONFIG["transport"]["retry"])
        if isinstance(retry, Mapping):
            defaults.update(retry)
        params["retry"] = defaults
        return params

    def get_guardrails_params(self) -> dict[str, Any]:
        """Training-health knobs (``guardrails.*`` — see
        docs/operations.md "Training-health guardrails"), defaults
        merged under user overrides; malformed values degrade to the
        built-ins (the guardrail plane must never crash the process it
        protects)."""
        params = dict(DEFAULT_CONFIG["guardrails"])
        params.update(self._section("guardrails"))
        params["enabled"] = bool(params.get("enabled", True))
        if params.get("ingest_validation") not in ("enforce", "warn", "off"):
            params["ingest_validation"] = "enforce"
        for key, default, lo in (
                ("strike_threshold", 3, 1),
                ("loss_window", 16, 4),
                ("reward_window", 32, 4),
                ("checkpoint_ring", 5, 1),
                ("max_rollbacks", 3, 0),
                ("ingest_soft_limit", 8192, 0)):
            try:
                params[key] = max(lo, int(params.get(key, default)))
            except (TypeError, ValueError):
                params[key] = default
        for key, default in (
                ("strike_window_s", 60.0), ("quarantine_cooldown_s", 300.0),
                ("rollback_window_s", 600.0), ("agent_share", 0.5),
                ("nack_retry_after_s", 1.0)):
            try:
                value = params.get(key, default)
                params[key] = max(0.0, float(default if value is None
                                             else value))
            except (TypeError, ValueError):
                params[key] = default
        for key, default in (
                ("max_param_norm", 1e6), ("max_update_norm", 0.0),
                ("loss_spike_factor", 0.0), ("reward_collapse_drop", 0.0)):
            # Trip thresholds honor the documented "0/null disables"
            # contract: an explicit null means the detector is OFF, not
            # back to a default that keeps it armed.
            try:
                value = params.get(key, default)
                params[key] = max(0.0, float(0.0 if value is None
                                             else value))
            except (TypeError, ValueError):
                params[key] = default
        try:
            max_steps = params.get("max_steps")
            params["max_steps"] = (None if max_steps is None
                                   else max(0, int(max_steps)))
        except (TypeError, ValueError):
            params["max_steps"] = None
        for key in ("watchdog", "probes", "update_norm_probe", "rollback"):
            params[key] = bool(params.get(key, True))
        if params.get("shed_policy") not in ("drop_oldest", "nack"):
            params["shed_policy"] = "drop_oldest"
        params["loss_key"] = str(params.get("loss_key") or "auto")
        return params

    def get_serving_params(self) -> dict[str, Any]:
        """Disaggregated batched-inference knobs (``serving.*`` — see
        docs/operations.md "Serving plane"), defaults merged under user
        overrides; malformed values degrade to the built-ins (the
        serving plane must not crash the training server hosting it)."""
        params = dict(DEFAULT_CONFIG["serving"])
        params.update(self._section("serving"))
        params["enabled"] = bool(params.get("enabled", False))
        for key, default, lo in (("max_batch", 16, 1),
                                 ("queue_limit", 1024, 1),
                                 ("max_sessions", 4096, 1),
                                 ("stream_window", 32, 1)):
            try:
                params[key] = max(lo, int(params.get(key, default)))
            except (TypeError, ValueError):
                params[key] = default
        for key, default in (("batch_timeout_ms", 5.0),
                             ("retry_after_s", 0.05),
                             ("stale_after_s", 5.0),
                             ("request_timeout_s", 2.0),
                             ("infer_deadline_s", 60.0),
                             ("session_ttl_s", 600.0)):
            try:
                value = params.get(key, default)
                params[key] = max(0.0, float(default if value is None
                                             else value))
            except (TypeError, ValueError):
                params[key] = default
        buckets = params.get("buckets")
        if isinstance(buckets, (list, tuple)) and buckets:
            try:
                clean = sorted({max(1, int(b)) for b in buckets})
                # The largest bucket must cover max_batch or full-size
                # closes could never dispatch without a clamp.
                if clean[-1] < params["max_batch"]:
                    clean.append(params["max_batch"])
                params["buckets"] = clean
            except (TypeError, ValueError):
                params["buckets"] = None
        else:
            params["buckets"] = None
        replicas = params.get("replicas")
        if isinstance(replicas, (list, tuple)) and replicas:
            params["replicas"] = [str(a) for a in replicas]
        else:
            params["replicas"] = None
        return params

    def get_relay_params(self) -> dict[str, Any]:
        """Relay-node knobs (``relay.*`` — see docs/architecture.md
        "relay tree" and docs/operations.md "Relay runbook"), defaults
        merged under user overrides; malformed values degrade to the
        built-ins (a relay must come up on a hand-edited config)."""
        params = dict(DEFAULT_CONFIG["relay"])
        params.update(self._section("relay"))
        params["enabled"] = bool(params.get("enabled", False))
        name = params.get("name")
        params["name"] = str(name) if name else None
        if params.get("upstream_type") not in ("zmq", "grpc", "native",
                                               "auto"):
            params["upstream_type"] = "zmq"
        if params.get("downstream_type") not in ("zmq", "grpc"):
            params["downstream_type"] = "zmq"
        for key in ("upstream", "downstream"):
            value = params.get(key)
            params[key] = dict(value) if isinstance(value, Mapping) else {}
        try:
            params["fanout_port"] = max(0, int(params.get("fanout_port", 0)))
        except (TypeError, ValueError):
            params["fanout_port"] = 0
        params["keyframe_cache"] = bool(params.get("keyframe_cache", True))
        try:
            params["batch_max"] = max(1, int(params.get("batch_max", 8)))
        except (TypeError, ValueError):
            params["batch_max"] = 8
        try:
            params["batch_linger_ms"] = max(0.0, float(
                params.get("batch_linger_ms", 5.0)))
        except (TypeError, ValueError):
            params["batch_linger_ms"] = 5.0
        try:
            params["spool_entries"] = max(0, int(
                params.get("spool_entries", 2048)))
        except (TypeError, ValueError):
            params["spool_entries"] = 2048
        try:
            params["spool_bytes"] = max(1 << 16, int(
                params.get("spool_bytes", 128 << 20)))
        except (TypeError, ValueError):
            params["spool_bytes"] = 128 << 20
        spool_dir = params.get("spool_dir")
        params["spool_dir"] = str(spool_dir) if spool_dir else None
        try:
            params["resync_min_interval_s"] = max(0.0, float(
                params.get("resync_min_interval_s", 0.25)))
        except (TypeError, ValueError):
            params["resync_min_interval_s"] = 0.25
        return params

    def get_rlhf_params(self) -> dict[str, Any]:
        """RLHF workload-plane knobs (``rlhf.*`` — see docs/operations.md
        "RLHF workload plane"), defaults merged under user overrides;
        malformed values degrade to the built-ins (the scheduler must
        come up on a hand-edited config)."""
        params = dict(DEFAULT_CONFIG["rlhf"])
        params.update(self._section("rlhf"))
        for key, default, lo in (("vocab_size", 8, 2),
                                 ("prompt_len", 3, 1),
                                 ("max_new_tokens", 8, 1),
                                 ("rm_d_model", 32, 4),
                                 ("rm_n_layers", 1, 1),
                                 ("rm_seed", 7, 0),
                                 ("lanes", 4, 1),
                                 ("generation_unroll", 8, 1),
                                 ("score_batch", 8, 1),
                                 ("score_queue", 256, 1),
                                 ("max_episodes_per_version", 64, 0)):
            try:
                params[key] = max(lo, int(params.get(key, default)))
            except (TypeError, ValueError):
                params[key] = default
        try:
            value = params.get("pace_timeout_s", 5.0)
            params["pace_timeout_s"] = max(0.1, float(
                5.0 if value is None else value))
        except (TypeError, ValueError):
            params["pace_timeout_s"] = 5.0
        if params.get("scorer") not in ("programmatic", "reward_model"):
            params["scorer"] = "programmatic"
        if params.get("generation_tier") not in ("vector", "remote",
                                                 "anakin"):
            params["generation_tier"] = "vector"
        return params

    def get_telemetry_params(self) -> dict[str, Any]:
        """Observability knobs (``telemetry.*`` — see
        docs/observability.md), defaults merged under user overrides.
        Malformed ``enabled``/``port`` degrade to disabled/default-port
        rather than crashing the process being observed."""
        params = dict(DEFAULT_CONFIG["telemetry"])
        params.update(self._section("telemetry"))
        params["enabled"] = bool(params.get("enabled", False))
        try:
            params["port"] = int(params.get("port", 9100))
        except (TypeError, ValueError):
            params["port"] = 9100
        params["host"] = str(params.get("host") or "127.0.0.1")
        try:
            params["events_max_bytes"] = max(
                0, int(params.get("events_max_bytes") or 0))
        except (TypeError, ValueError):
            params["events_max_bytes"] = 0
        try:
            params["trace_sample_rate"] = min(
                1.0, max(0.0, float(params.get("trace_sample_rate") or 0.0)))
        except (TypeError, ValueError):
            params["trace_sample_rate"] = 0.0
        try:
            params["trace_ring"] = max(16, int(params.get("trace_ring")
                                               or 4096))
        except (TypeError, ValueError):
            params["trace_ring"] = 4096
        try:
            params["fleet_interval_s"] = max(0.0, float(
                params.get("fleet_interval_s") or 0.0))
        except (TypeError, ValueError):
            params["fleet_interval_s"] = 0.0
        try:
            params["fleet_stale_s"] = max(1.0, float(
                params.get("fleet_stale_s") or 15.0))
        except (TypeError, ValueError):
            params["fleet_stale_s"] = 15.0
        if params["fleet_interval_s"] > 0:
            # The stale window must cover at least two emission
            # intervals, or the root evicts every proc between its own
            # frames and the table flaps (evict/rejoin per interval).
            floor = 2.0 * params["fleet_interval_s"]
            if params["fleet_stale_s"] < floor:
                import warnings

                warnings.warn(
                    f"telemetry.fleet_stale_s "
                    f"({params['fleet_stale_s']}) < 2x fleet_interval_s; "
                    f"raising to {floor} so procs don't flap out of the "
                    f"fleet table between their own frames")
                params["fleet_stale_s"] = floor
        alerts = params.get("alerts")
        if isinstance(alerts, Mapping):
            # A single rule object is a natural way to write one rule —
            # accept it as a one-element list instead of dropping it.
            alerts = [dict(alerts)]
        elif alerts is not None and not isinstance(alerts, (list, tuple)):
            import warnings

            warnings.warn(
                f"telemetry.alerts must be a list of rule objects; got "
                f"{type(alerts).__name__} — ignoring")
            alerts = None
        params["alerts"] = list(alerts) if alerts is not None else None
        params["alerts_default_pack"] = bool(
            params.get("alerts_default_pack", True))
        return params

    def raw(self) -> dict:
        return self._raw


def resolve_config_path(
    config_path: str | os.PathLike | None, create_if_missing: bool = True
) -> Path | None:
    """Resolve (and optionally auto-create) the config file
    (ref: resolve_config_json_path!/get_or_create_config_json_path!,
    config_loader.rs:12-113 — writes the embedded default to cwd if absent)."""
    path = Path(config_path) if config_path is not None else Path.cwd() / DEFAULT_CONFIG_FILENAME
    if path.is_file():
        return path
    if create_if_missing:
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            with open(path, "w") as f:
                json.dump(default_config(), f, indent=2)
            return path
        except OSError:
            return None
    return None
