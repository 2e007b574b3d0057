"""The training server process: trajectory ingest → learner → model publish.

Counterpart of :mod:`relayrl_tpu.runtime.server`, single host, for the
on-policy family. Transport threads put raw payloads on an ingest queue; a
staging thread decodes them (per-record msgpack through the native codec
when its library loads, else in Python, or a columnar RLD1 frame) into a
decoded queue; the native transport's drain hands over trajectories its
C++ core already decoded, through the same guardrail funnel; one learner
thread drains the queue into the algorithm's update, which enters the
in-flight window unfenced; a publisher thread turns each update's params
snapshot into a model-wire v2 frame (or a v1 bundle) and broadcasts it. Sequence-tagged trajectories are admitted at
most once per agent (:class:`~relayrl_tpu_torch.runtime.spool.
SequenceLedger`), and the ledger is saved beside every checkpoint, so a
resumed server dedups exactly what its restored params already trained
on.

The training-health guardrails (:mod:`relayrl_tpu_torch.guardrails`, on
by default as in the reference) sit on every path: ingest sheds a halted
server's and a quarantined agent's sends, then applies admission
backpressure; the staging thread validates each decoded trajectory and
strikes its agent; an ack-capable transport (gRPC) asks
:meth:`TrainingServer._check_ingest` first and answers a refused send
with a typed nack. The device probes ride each update's metrics; the
learner thread resolves them at the in-flight fence, and a watchdog trip
rolls the learner back to the newest healthy-tagged checkpoint (params
and Adam state restored in place, the version fast-forwarded, a forced
keyframe published), or halts when the rollback budget is spent. The
publish gate keeps non-finite params off the wire.

The ctor takes the JAX server's arguments plus ``device`` (default: the
GPU; without one the caller must pass ``device="cpu"``). On the GPU every
kernel library is built and loaded in the constructor, before any thread
starts, so a kernel that fails to build fails the construction instead of
the learner thread. The learner thread still never dies on one bad batch;
every exception it catches is counted in ``stats["learner_errors"]``.

With ``serving.enabled`` (or ``serving=True``) the server hosts the
batched-inference serving plane (:class:`~relayrl_tpu_torch.runtime.inference.InferenceService`)
on its device, fed every publish in-process: in-band ``GetActions`` and
``StreamActions`` on the pure-grpcio backend, else the ZMQ ROUTER plane
at ``server.inference_server``.

Distributed tracing (``telemetry.trace_sample_rate > 0``) records the
ingest, dedup, staging and update hops of every sampled trajectory and
the dispatch, fence, encode and publish hops of every sampled version;
fleet aggregation (``telemetry.fleet_interval_s > 0``) makes this server
the fleet's root: snapshot frames from agents and relays land in a
:class:`~relayrl_tpu_torch.telemetry.aggregate.FleetTable` behind
``/fleet``, and the SLO alert rules run over the merged snapshot each
interval. ``tensorboard=True`` tails the epoch log into TensorBoard
scalars.

Multi-process learner (``learner.distributed``, or ``RELAYRL_COORDINATOR``,
``RELAYRL_NUM_PROCESSES`` and ``RELAYRL_PROCESS_ID`` on each process): the
constructor starts the process group first
(:func:`~relayrl_tpu_torch.parallel.distributed.initialize_distributed`,
which prints its backend rule's choice), pins ``seed_salt`` 0 so every
process starts from the same state, restores a resume on every process
from the shared checkpoint directory, then runs the update over
``make_mesh(learner.mesh or {"dp": -1})``, whose ``dp`` axis spans the
processes. Only the coordinator (process 0) owns a transport, ingests,
publishes and logs epochs. Every process runs
:meth:`TrainingServer._learner_loop_multihost`: each tick the coordinator
broadcasts a descriptor (STEP with the batch's shape, IDLE, or STOP), a
STEP's batch follows it, and every process trains on its rows in
lockstep; checkpoints are collective (the coordinator writes, every
process waits). The divergence watchdog's detector and its rollback stay
single-process, as in the reference.
"""

from __future__ import annotations

import os
import queue
import threading
import time
import traceback
from typing import Any, Mapping

import torch

from relayrl_tpu_torch.algorithms import build_algorithm, registered_algorithms
from relayrl_tpu_torch.config import ConfigLoader
from relayrl_tpu_torch.models import resolve_device
from relayrl_tpu_torch.telemetry.aggregate import is_snapshot_frame
from relayrl_tpu_torch.telemetry.trace import split_ctx
from relayrl_tpu_torch.transport.base import (
    BATCH_KIND_ENVELOPES,
    batch_kind,
    split_agent_seq,
    split_batch,
    swallow_decode_error,
    unpack_trajectory_envelope,
)
from relayrl_tpu_torch.types.columnar import DecodedTrajectory
from relayrl_tpu_torch.types.trajectory import deserialize_actions


class _TracedRecords(list):
    """A ``list[ActionRecord]`` that can carry a trace context attribute
    (plain lists cannot); behaves identically through accumulate."""

    trace_ctx = None


def _attach_trace_ctx(item, ctx):
    """Hang a sampled trajectory's trace context on the decoded item so
    the learner thread can attribute the consuming update dispatch."""
    if isinstance(item, DecodedTrajectory):
        item.trace_ctx = ctx
        return item
    if isinstance(item, list):
        if item and isinstance(item[0], DecodedTrajectory):
            item[0].trace_ctx = ctx  # coalesced frames: one ctx, one seq
            return item
        wrapped = _TracedRecords(item)
        wrapped.trace_ctx = ctx
        return wrapped
    return item


class _EventCoalescer:
    """≤1 journal event per ``min_interval_s`` for burst-prone counters
    (ingest drops, duplicate replays); one instance per event type,
    mutated under the owner's lock."""

    def __init__(self, min_interval_s: float = 1.0):
        self.pending = 0
        self._last = 0.0
        self._min = min_interval_s

    def add(self, n: int) -> int | None:
        self.pending += n
        if time.monotonic() - self._last >= self._min:
            due, self.pending = self.pending, 0
            self._last = time.monotonic()
            return due
        return None

    def flush(self) -> int:
        due, self.pending = self.pending, 0
        if due:
            self._last = time.monotonic()
        return due


class TrainingServer:
    def __init__(
        self,
        algorithm_name: str = "REINFORCE",
        obs_dim: int = 4,
        act_dim: int = 2,
        buf_size: int | None = None,
        tensorboard: bool = False,
        multiactor: bool = True,
        env_dir: str | None = None,
        algorithm_dir: str | None = None,
        config_path: str | None = None,
        hyperparams: Mapping[str, Any] | None = None,
        server_type: str = "zmq",
        start: bool = True,
        resume: bool = False,
        handle_signals: bool = False,
        serving: bool | None = None,
        device=None,
        **addr_overrides,
    ):
        self.config = ConfigLoader(algorithm_name, config_path)
        self.server_type = server_type
        self._addr_overrides = addr_overrides
        # The multi-process bring-up comes before any other device use (a
        # no-op for the default single-process config).
        from relayrl_tpu_torch.parallel import distributed

        self.distributed_info = distributed.initialize_distributed(
            config=self.config.get_learner_params())
        multi_host = self.distributed_info["multi_host"]
        if multi_host:
            print(f"[TrainingServer] multi-host learner: process "
                  f"{self.distributed_info['process_id']}/"
                  f"{self.distributed_info['num_processes']}, backend "
                  f"{distributed.backend()} (nccl when every rank has a card "
                  f"of its own, gloo on the CPU or when ranks share a card)",
                  flush=True)
        # A process's cards as the process group resolved them: the first
        # is the server's device unless the caller names one.
        mesh_devices = [] if device is not None else distributed.local_devices()
        self.device = resolve_device(mesh_devices[0] if mesh_devices else device)
        if self.device.type == "cuda" and self.device.index is None:
            # The learner thread selects this card by index.
            self.device = torch.device("cuda", torch.cuda.current_device())

        from relayrl_tpu_torch import telemetry

        self._telemetry = telemetry.configure_from_config(self.config)
        self._exporter = telemetry.maybe_serve()
        reg = self._telemetry
        self._m_trajectories = reg.counter(
            "relayrl_server_trajectories_total",
            "trajectories handed to the learner plane")
        self._m_updates = reg.counter(
            "relayrl_server_updates_total", "learner updates dispatched")
        self._m_dropped = reg.counter(
            "relayrl_server_dropped_total",
            "payloads lost at ingest (full queue / decode failure)")
        self._m_nonfinite = reg.gauge(
            "relayrl_server_dropped_nonfinite",
            "trajectories rejected by the finite-value guard")
        self._m_decode = reg.histogram(
            "relayrl_server_decode_seconds",
            "one payload decode on a staging worker")
        self._m_columnar_frames = reg.counter(
            "relayrl_server_columnar_frames_total",
            "columnar trajectory frames decoded straight into "
            "DecodedTrajectory (the wire fast path)")
        self._m_columnar_bytes = reg.counter(
            "relayrl_server_columnar_bytes_total",
            "columnar trajectory frame bytes decoded")
        self._m_columnar_rejects = reg.counter(
            "relayrl_server_columnar_rejects_total",
            "columnar frames refused at decode (CRC mismatch / "
            "malformed layout) — also counted in dropped_total")
        self._m_dispatch = reg.histogram(
            "relayrl_server_dispatch_seconds",
            "learner-thread host work per trajectory: accumulate + "
            "assemble + async update dispatch")
        self._m_duplicates = reg.counter(
            "relayrl_server_duplicate_trajectories_total",
            "sequence-tagged trajectories dropped by idempotent ingest "
            "(replays, retry storms, duplicate-injection faults)")
        # The scheduler's emit-side lag histogram's grid, so the two
        # distributions compare bucket for bucket.
        from relayrl_tpu_torch.rlhf.scheduler import LAG_BUCKETS

        self._m_rlhf_train_lag = reg.histogram(
            "relayrl_rlhf_train_lag_versions",
            "behavior version (data['bver'], stamped at generation) vs "
            "the learner's dispatched version when the trajectory "
            "trains — the off-policy distance V-trace corrects; "
            "observed for trajectories that carry bver",
            buckets=LAG_BUCKETS)
        self._m_learner_errors = reg.counter(
            "relayrl_server_learner_errors_total",
            "exceptions caught on the learner thread (the loop survives "
            "them; each one is counted and printed)")
        self._m_ckpt_failures = reg.counter(
            "relayrl_server_checkpoint_failures_total",
            "periodic/final checkpoint saves that raised")
        self._m_ckpt_consecutive = reg.gauge(
            "relayrl_server_checkpoint_consecutive_failures",
            "checkpoint failures since the last successful save")
        self._ckpt_consecutive_failures = 0
        self._drop_events = _EventCoalescer()
        self._dup_events = _EventCoalescer()

        # Fleet telemetry aggregation (telemetry/aggregate.py): the root
        # holds the fleet table. Every process's snapshot frames land
        # here through the ordinary ingest funnel (sniffed by RLS1 magic
        # in _ingest_one, O(relays) frames under a relay tree); the fleet
        # tick folds this server's own registry in, evicts stale procs
        # and runs the SLO alert rules over the merged snapshot. Gated
        # like tracing: registry live AND telemetry.fleet_interval_s > 0.
        tel_params = self.config.get_telemetry_params()
        self._fleet = None
        self._alerts = None
        self._fleet_interval_s = float(tel_params.get("fleet_interval_s")
                                       or 0.0)
        self._fleet_stop = threading.Event()
        self._fleet_thread: threading.Thread | None = None
        self._fleet_proc = f"server-{os.getpid()}"
        if reg.enabled and self._fleet_interval_s > 0:
            from relayrl_tpu_torch.telemetry.aggregate import (
                AlertEngine,
                FleetTable,
                rules_from_config,
            )

            self._fleet = FleetTable(
                stale_s=tel_params.get("fleet_stale_s", 15.0), registry=reg)
            self._alerts = AlertEngine(rules_from_config(tel_params),
                                       registry=reg)
            if self._exporter is not None:
                self._exporter.set_fleet(self._fleet, self._alerts)

        from relayrl_tpu_torch import faults

        faults.maybe_install_from_env()
        self._fault_ingest = faults.site("server.ingest")
        self._fault_publish = faults.site("server.publish")

        # Training-health guardrails: ingest validation + quarantine,
        # divergence watchdog, last-known-good rollback, and ingest
        # backpressure. None when guardrails.enabled is false — every hook
        # site below then costs one identity check.
        from relayrl_tpu_torch.guardrails import build_guardrails

        self.guardrails = build_guardrails(self.config)
        # Rollback bookkeeping (learner thread only): times of executed
        # rollbacks inside the budget window, and the halt latch (halted:
        # ingest sheds, training stops, the process stays up).
        self._rollback_times: list[float] = []
        self._rollbacks_total = 0
        self._halted = False

        if self.device.type == "cuda":
            # Every kernel library built and loaded here, on the calling
            # thread: a kernel that fails to build fails construction,
            # never the learner thread.
            from relayrl_tpu_torch import _kernels

            torch.cuda.set_device(self.device)
            _kernels.build()
            for name in _kernels.KERNELS:
                _kernels.load(name)

        if algorithm_dir:
            _load_plugin_algorithms(algorithm_dir)
        if isinstance(hyperparams, (list, tuple)):
            hp = {k: _coerce(v) for k, v in
                  (kv.split("=", 1) for kv in hyperparams)}
        else:
            hp = dict(hyperparams or {})
        if multi_host:
            # Every process must start from the same state; the default
            # seed_salt (the process id) would fork the inits.
            hp.setdefault("seed_salt", 0)
        self.algorithm = build_algorithm(
            algorithm_name,
            env_dir=env_dir,
            config_path=(str(self.config.config_path)
                         if self.config.config_path else None),
            obs_dim=obs_dim,
            act_dim=act_dim,
            buf_size=buf_size,
            device=self.device,
            **hp,
        )
        if self.guardrails is not None:
            # Installs the device probes (observers: params stay
            # bit-identical to guardrails-off) and aligns the algorithm's
            # finite guard with the validation mode.
            self.guardrails.attach_algorithm(self.algorithm)

        learner_cfg = self.config.get_learner_params()
        from relayrl_tpu_torch.algorithms.base import anchor_path

        self._checkpoint_dir = learner_cfg.get("checkpoint_dir", "checkpoints")
        if self._checkpoint_dir:
            self._checkpoint_dir = anchor_path(self._checkpoint_dir, env_dir)
        self._checkpoint_every = max(
            1, int(learner_cfg.get("checkpoint_every_epochs", 10)))
        from relayrl_tpu_torch.checkpoint import CheckpointManager

        self._aux_every = max(
            1, int(learner_cfg.get("checkpoint_aux_every", 1)))
        self._ckpt_keep = max(CheckpointManager.DEFAULT_MAX_TO_KEEP,
                              self._aux_every)
        if self.guardrails is not None and self.guardrails.params["rollback"]:
            # The last-known-good ring: retain at least checkpoint_ring
            # steps, so the rollback search has healthy-tagged candidates
            # even when the newest saves straddled the divergence.
            self._ckpt_keep = max(self._ckpt_keep,
                                  self.guardrails.params["checkpoint_ring"])
        self._ckpt_saves = 0

        from relayrl_tpu_torch.runtime.spool import SequenceLedger

        try:
            dedup_window = int(learner_cfg.get("ingest_dedup_window", 4096))
        except (TypeError, ValueError):
            dedup_window = 4096
        self._ingest_ledger = (SequenceLedger(dedup_window)
                               if dedup_window > 0 else None)

        if resume and self._checkpoint_dir:
            # Multi-process: every process restores the same step from the
            # shared directory before enable_multihost places the state,
            # like a fresh seed_salt 0 init.
            from relayrl_tpu_torch.checkpoint import restore_algorithm

            try:
                restore_algorithm(self.algorithm, self._checkpoint_dir)
                print(f"[TrainingServer] resumed at version "
                      f"{self.algorithm.version}", flush=True)
                self._load_ledger_sidecar(self.algorithm.version)
            except FileNotFoundError:
                print("[TrainingServer] no checkpoint to resume; fresh start",
                      flush=True)

        if multi_host:
            if not hasattr(self.algorithm, "enable_multihost"):
                raise NotImplementedError(
                    f"{algorithm_name} has no multi-host support "
                    "(enable_multihost)")
            from relayrl_tpu_torch.parallel import make_mesh

            self._mh_mesh = make_mesh(learner_cfg.get("mesh") or {"dp": -1},
                                      mesh_devices or [self.device])
            self.algorithm.enable_multihost(self._mh_mesh)
            print(f"[TrainingServer] multi-host mesh "
                  f"{dict(self._mh_mesh.shape)} over "
                  f"{len(self._mh_mesh.devices.flat)} devices", flush=True)

        self.multiactor = bool(multiactor)
        self.agent_ids: list[str] = []
        self._registry_lock = threading.Lock()

        self._ingest: queue.Queue = queue.Queue(maxsize=100_000)
        self._decoded: queue.Queue = queue.Queue(maxsize=100_000)
        import weakref

        wref = weakref.ref(self)

        def _queue_depth(attr):
            def read():
                server = wref()
                return (None if server is None
                        else getattr(server, attr).qsize())
            return read

        def _registered():
            server = wref()
            return None if server is None else len(server.agent_ids)

        reg.gauge_fn("relayrl_server_ingest_queue_depth",
                     _queue_depth("_ingest"),
                     "raw payloads awaiting a decode worker")
        reg.gauge_fn("relayrl_server_decoded_queue_depth",
                     _queue_depth("_decoded"),
                     "decoded trajectories awaiting the learner thread")
        reg.gauge_fn("relayrl_server_registered_agents", _registered,
                     "logical agents currently in the registry")
        self._bundle_lock = threading.Lock()
        self._bundle_bytes: bytes = self.algorithm.bundle().to_bytes()
        self._bundle_version: int = self.algorithm.version
        # Latest published model as a HOST tree (version, arch, params);
        # the v1 bundle bytes for handshakes serialize lazily from it.
        self._bundle_host: tuple[int, dict, object] | None = None
        transport_cfg = self.config.get_transport_params()
        self._wire_encoder = None
        if int(transport_cfg.get("wire_version", 2)) >= 2:
            from relayrl_tpu_torch.transport.modelwire import ModelWireEncoder

            self._wire_encoder = ModelWireEncoder(
                keyframe_interval=transport_cfg["keyframe_interval"],
                compress=transport_cfg["compress"],
                small_model_bytes=transport_cfg.get("small_model_bytes"))
        self._resync_lock = threading.Lock()
        self._last_resync_grant = -1e9
        self._resync_min_interval_s = float(
            transport_cfg.get("resync_min_interval_s", 0.25))
        self._m_resync_requests = reg.counter(
            "relayrl_server_resync_requests_total",
            "CMD_RESYNC keyframe requests received from the broadcast "
            "plane (actors with a diverged delta base)")
        self._m_resync_granted = reg.counter(
            "relayrl_server_resync_keyframes_total",
            "resync requests that forced the next publish to keyframe")

        # Only the coordinator owns the actor plane: the other processes
        # run learner steps.
        self.transport = None
        if distributed.is_coordinator():
            self._make_transport()

        # The batched-inference serving plane, colocated with this
        # learner and fed in-process from the publish path: thin clients
        # get batched actions with no model-distribution hop. gRPC fleets
        # ride the in-band GetActions RPC; zmq and native fleets the ROUTER
        # plane.
        self.inference = None
        serving_cfg = self.config.get_serving_params()
        if serving is not None:
            # Ctor override for callers that decide the topology in code
            # (examples/train_distributed.py --host-mode remote).
            serving_cfg["enabled"] = bool(serving)
        if serving_cfg["enabled"] and self.transport is not None:
            from relayrl_tpu_torch.runtime.inference import InferenceService

            try:
                self.inference = InferenceService.from_config(
                    self.algorithm.bundle(), self.config, validate=False,
                    device=self.device)
            except ValueError as e:
                # An unservable policy config: the server still comes up
                # for the local actor tiers.
                print(f"[TrainingServer] serving disabled: {e}", flush=True)
            if self.inference is not None:
                self._wire_serving_plane(addr_overrides)

        self._stop = threading.Event()
        self._learner_thread: threading.Thread | None = None
        self._staging_threads: list[threading.Thread] = []
        self._mh_ready: list = []   # assembled-but-untrained batches
        self._mh_busy = False       # a broadcast step is in flight
        self.active = False
        self._async_publish = bool(learner_cfg.get("async_publish", True))
        self._prefetch = bool(learner_cfg.get("device_prefetch", True))
        self._staging_count = max(
            1, int(learner_cfg.get("ingest_staging_threads", 1)))
        self._publisher = None
        self._artifact_version = int(self.algorithm.version)
        self._ckpt_version = int(self.algorithm.version)
        from collections import deque

        self._pending_logs: deque = deque()
        # Sampled trajectory contexts consumed since the last dispatch
        # (learner thread only), closed out by _trace_dispatch.
        self._trace_pending: deque = deque(maxlen=8192)
        self._timings_lock = threading.Lock()
        # "dropped": transport/queue losses; "learner_errors": exceptions
        # the learner thread caught (zero in a healthy run);
        # "publish_errors": publishes that raised on the learner thread.
        self.stats = {"trajectories": 0, "updates": 0, "dropped": 0,
                      "dropped_nonfinite": 0, "learner_errors": 0,
                      "publish_errors": 0}
        # Which decoder took each trajectory: "native" (the C++ codec, in
        # the native drain or through NativeDecoder), "python" (per-record
        # msgpack in Python) or "columnar" (an RLD1 wire frame, parsed in
        # Python). Counted past the dedup ledger and before validation, so
        # on a clean run the three sum to the trajectories accepted.
        self.decoded_by = {"native": 0, "python": 0, "columnar": 0}
        self.last_learner_error: str | None = None
        # Wire bytes of every publish by frame kind, appended by the
        # publisher thread (the keys are fixed, so readers on other
        # threads may iterate the dict).
        self.publish_bytes: dict[str, list[int]] = {
            "keyframe": [], "delta": [], "v1_passthrough": [], "v1": []}
        self.last_publish: dict | None = None
        # Per-thread time ledger (seconds), the JAX server's keys.
        self.timings = {"decode_s": 0.0, "learn_s": 0.0, "dispatch_s": 0.0,
                        "device_wait_s": 0.0, "publish_s": 0.0,
                        "learner_idle_s": 0.0, "warmup_s": 0.0}
        self._warmup_done = threading.Event()

        self._tb = None
        if tensorboard:
            from relayrl_tpu_torch.utils.tb_writer import TensorboardWriter

            self._tb = TensorboardWriter.from_logger(
                self.algorithm.logger, self.config.get_tb_params())

        if handle_signals:
            self._install_signal_handlers()
        if start:
            self.enable_server()

    def _make_transport(self) -> None:
        from relayrl_tpu_torch.transport import make_server_transport

        self.transport = make_server_transport(
            self.server_type, self.config, **self._addr_overrides)
        self.transport.on_trajectory = self._on_trajectory
        self.transport.on_trajectory_decoded = self._on_trajectory_decoded
        self.transport.get_model = self._get_model
        self.transport.on_register = self._on_register
        self.transport.on_unregister = self._on_unregister
        self.transport.on_resync = self._on_resync_request
        if self.guardrails is not None:
            # Ack-capable transports (gRPC) answer a refused send with a
            # typed nack (quarantine / overload) instead of a silent
            # server-side shed — see _check_ingest.
            self.transport.check_ingest = self._check_ingest
        if getattr(self.transport, "serves_full_bundles_only", False):
            # The native C++ gRPC long-polls ship the stored full bundle
            # to every subscriber: delta frames would be encoded and never
            # sent.
            self._wire_encoder = None
        if self._wire_encoder is not None:
            # Pull transports (gRPC long-polls) choose delta-vs-full per
            # subscriber through this surface; the version probe keeps
            # their wakeup checks from forcing lazy serializes.
            self.transport.get_model_update = self._get_model_update
            self.transport.get_model_version = (
                lambda: self.latest_model_version)

    def _wire_serving_plane(self, addr_overrides: dict) -> None:
        """Attach the InferenceService's action channel to the fleet's
        transport kind: in-band ``GetActions`` where the backend carries
        request/response RPCs (pure-grpcio), else the dedicated zmq
        ROUTER plane at ``server.inference_server`` (zmq fleets, and
        native ones as the passthrough: the C++ core has no action RPC)."""
        if getattr(self.transport, "supports_inband_infer", False):
            self.transport.on_infer = self.inference.handle_request_blocking
            # Bidi StreamActions: one parked RPC thread per stream
            # whatever its in-flight depth; frames go through the
            # non-blocking enqueue, replies ride the batch worker.
            self.transport.on_infer_submit = self.inference.handle_request
        else:
            self.inference.bind_zmq(addr_overrides.get(
                "serving_addr", self.config.get_inference_server().address))

    def _install_signal_handlers(self) -> None:
        """Opt-in SIGTERM/SIGINT handling: write a final full-state
        checkpoint, shut the planes down cleanly, then die by the SAME
        signal so supervisors see an honest exit status. Main thread
        only (elsewhere a no-op with a note)."""
        import signal

        def _handler(signum, frame):
            for sig in (signal.SIGTERM, signal.SIGINT):
                signal.signal(sig, signal.SIG_DFL)
            name = signal.Signals(signum).name
            print(f"[TrainingServer] {name}: final checkpoint + clean "
                  f"shutdown", flush=True)
            try:
                # Multi-process: peers may be mid-collective and only this
                # process got the signal, so the quiesce is bounded and the
                # final save (a collective) is left to the periodic ones.
                multi_host = self.distributed_info["multi_host"]
                self.disable_server(join_timeout=10.0 if multi_host else None)
                if (self._checkpoint_dir and self.algorithm.version > 0
                        and not multi_host):
                    from relayrl_tpu_torch.checkpoint import (
                        checkpoint_algorithm,
                    )

                    try:
                        checkpoint_algorithm(self.algorithm,
                                             self._checkpoint_dir, wait=True,
                                             overwrite=True,
                                             extra_meta=self._health_tag())
                        self._save_ledger_sidecar(self.algorithm.version)
                    except Exception as e:
                        self._m_ckpt_failures.inc()
                        from relayrl_tpu_torch import telemetry

                        telemetry.emit("checkpoint_failed",
                                       version=self.algorithm.version,
                                       error=repr(e), consecutive=1,
                                       dir=str(self._checkpoint_dir))
                        print(f"[TrainingServer] final checkpoint skipped: "
                              f"{e!r}", flush=True)
            finally:
                signal.raise_signal(signum)

        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                signal.signal(sig, _handler)
        except ValueError:  # not the main thread
            print("[TrainingServer] handle_signals requested off the main "
                  "thread — skipped (install handlers in your main thread "
                  "and call disable_server there instead)", flush=True)

    @staticmethod
    def _get_tracer():
        from relayrl_tpu_torch.telemetry import trace as trace_mod

        return trace_mod.get_tracer()

    # -- transport callbacks (transport threads!) --
    def _count_dropped(self, n: int = 1) -> None:
        with self._timings_lock:
            self.stats["dropped"] += n
            total = self.stats["dropped"]
            due = self._drop_events.add(n)
        self._m_dropped.inc(n)
        if due:
            from relayrl_tpu_torch import telemetry

            telemetry.emit("drop", n=due, total=total)

    def _flush_drop_event(self) -> None:
        with self._timings_lock:
            pending = self._drop_events.flush()
            total = self.stats["dropped"]
            dup_pending = self._dup_events.flush()
        if pending or dup_pending:
            from relayrl_tpu_torch import telemetry

            if pending:
                telemetry.emit("drop", n=pending, total=total)
            if dup_pending:
                telemetry.emit("duplicate_drop", n=dup_pending)

    def _count_duplicate(self, n: int = 1) -> None:
        self._m_duplicates.inc(n)
        with self._timings_lock:
            due = self._dup_events.add(n)
        if due:
            from relayrl_tpu_torch import telemetry

            telemetry.emit("duplicate_drop", n=due)

    def _admit_seq(self, agent_id: str):
        """Split the sequence and trace tags off an envelope id and
        consult the dedup ledger: ``(clean_agent_id, seq, ctx, admit)``.
        Both tags strip unconditionally: a trace context never leaks into
        attribution or quarantine keys, even when this process records no
        spans. Untagged ids admit with seq and ctx None."""
        clean_id, seq = split_agent_seq(agent_id)
        clean_id, ctx = split_ctx(clean_id)
        if seq is None or self._ingest_ledger is None:
            return clean_id, seq, ctx, True
        if not self._ingest_ledger.accept(clean_id, seq):
            self._count_duplicate()
            return clean_id, seq, ctx, False
        return clean_id, seq, ctx, True

    def _retract(self, agent_id: str, seq) -> None:
        """Un-see a seq: the payload never reached the learner, so the
        sender's spool replay must be able to land it later."""
        if seq is not None and self._ingest_ledger is not None:
            self._ingest_ledger.retract(agent_id, seq)

    def _on_trajectory(self, agent_id: str, payload: bytes) -> None:
        if self._fault_ingest is not None:
            for delay_s, part in self._fault_ingest.inject(payload):
                if delay_s > 0:
                    time.sleep(delay_s)
                self._ingest_one(agent_id, part)
            return
        self._ingest_one(agent_id, payload)

    def _check_ingest(self, tagged_id: str):
        """Guardrail admission verdict for ack-capable transports (the
        gRPC servicer calls this BEFORE on_trajectory): ``None`` admits;
        ``(nack_code, reason, retry_after_s)`` goes back to the sender as
        a typed nack its spool understands (quarantine → discard the
        entry; overload → keep it, replay later). Broadcast planes never
        call this; _ingest_one enforces the same verdicts server-side.
        Runs on transport threads."""
        g = self.guardrails
        if g is None:
            return None
        from relayrl_tpu_torch.transport.base import (
            NACK_OVERLOADED,
            NACK_QUARANTINED,
            split_agent_trace,
        )

        agent_id, _ = split_agent_seq(tagged_id)
        agent_id, _ = split_agent_trace(agent_id)
        if self._halted:
            # Not counted as a halted drop: the sender's spool retains an
            # overload-nacked entry and replays it.
            return (NACK_OVERLOADED, "guardrails halted", 30.0)
        if g.quarantine.is_quarantined(agent_id):
            g.quarantine.count_rejected_send()
            return (NACK_QUARANTINED, "agent quarantined",
                    g.quarantine.retry_after(agent_id))
        adm = g.admission
        if adm is not None and adm.policy == "nack":
            # Under the nack shed policy the back-channel IS the shed:
            # decide here so the sender's spool keeps the entry and
            # retries after the hint (admit() only moves shed counters,
            # so an "admit" here followed by _ingest_one's re-check is
            # harmless).
            verdict = adm.admit(agent_id)
            if verdict in ("nack", "shed_agent"):
                reason = ("agent over fair share"
                          if verdict == "shed_agent" else "ingest overloaded")
                return (NACK_OVERLOADED, reason, adm.retry_after_s)
        return None

    def _ingest_one(self, agent_id: str, payload: bytes,
                    depth: int = 0) -> None:
        if is_snapshot_frame(payload):
            # Fleet telemetry frame: to the fleet table BEFORE dedup and
            # guardrails (telemetry carries no seqs and never strikes a
            # quarantine book); a fleet-less server drops it as inert
            # noise rather than a decode failure.
            fleet = self._fleet
            if fleet is not None:
                try:
                    fleet.ingest_frame(payload)
                except ValueError as e:
                    swallow_decode_error(self.server_type, "fleet_frame", e)
            return
        if batch_kind(payload) == BATCH_KIND_ENVELOPES and depth < 8:
            # One send carrying N whole envelopes (a relay's upstream
            # forward): each inner envelope goes through the per-agent
            # funnel, so dedup sees exactly what a flat fleet sends.
            try:
                parts = split_batch(payload)
            except ValueError as e:
                swallow_decode_error(self.server_type, "envelope_batch", e)
                self._count_dropped()
                return
            for part in parts:
                try:
                    inner_id, inner_payload = unpack_trajectory_envelope(part)
                except Exception as e:
                    swallow_decode_error(self.server_type,
                                         "envelope_batch", e)
                    self._count_dropped()
                    continue
                self._ingest_one(inner_id, inner_payload, depth=depth + 1)
            return
        # Trace hops (telemetry/trace.py): clock reads gate on a live
        # tracer, span recording on the envelope carrying a sampled
        # context; the untraced path pays one attribute check.
        tracer = self._get_tracer()
        t_arr = time.monotonic_ns() if tracer.enabled else 0
        agent_id, seq, ctx, admit = self._admit_seq(agent_id)
        if not tracer.enabled:
            # The tag is stripped regardless; the context only FLOWS when
            # this process traces (a trace-off server in a traced fleet
            # must not accumulate contexts it never drains).
            ctx = None
        elif ctx is not None:
            t_ded = time.monotonic_ns()
            tracer.span("traj", ctx.trace_id, "ingest", t_arr, t_arr,
                        agent=agent_id, seq=seq)
            tracer.span("traj", ctx.trace_id, "dedup", t_arr, t_ded,
                        admitted=bool(admit))
        if not admit:
            return
        g = self.guardrails
        if g is not None:
            if self._halted:
                g._m_halted_drops.inc()
                self._retract(agent_id, seq)
                return
            if g.quarantine.is_quarantined(agent_id):
                # Broadcast planes (zmq PUSH) have no per-send
                # back-channel: the quarantine sheds here, silently to the
                # sender, loudly to telemetry.
                g.quarantine.count_rejected_send()
                self._retract(agent_id, seq)
                return
            if g.admission is not None:
                verdict = g.admission.admit(agent_id)
                if verdict in ("shed_agent", "nack"):
                    self._retract(agent_id, seq)
                    return
                if verdict == "evict":
                    self._evict_oldest_raw()
        try:
            self._ingest.put_nowait((agent_id, seq, ctx, payload))
            if g is not None and g.admission is not None:
                g.admission.note_enqueued(agent_id)
        except queue.Full:
            self._retract(agent_id, seq)
            self._count_dropped()

    def _evict_oldest_raw(self) -> None:
        """drop_oldest shed: evict the globally oldest queued raw payload
        to admit a fresh one (freshest data wins). The victim's seq is
        retracted from the dedup ledger, so its actor's spool can
        redeliver it when pressure clears."""
        try:
            victim_id, victim_seq, _ctx, _ = self._ingest.get_nowait()
        except queue.Empty:
            return
        self._ingest.task_done()
        self._retract(victim_id, victim_seq)
        self.guardrails.admission.note_dequeued(victim_id)

    def _count_decoded(self, codec: str, n: int = 1) -> None:
        with self._timings_lock:
            self.decoded_by[codec] += n

    def _on_trajectory_decoded(self, batch, codec: str = "native") -> None:
        """A batch the native drain already decoded (``codec`` "native":
        the C++ codec; "columnar": wire frames the drain parsed), one
        queue entry per drain, skipping the staging thread. Sequence tags
        ride the items' agent ids through the C++ core; they are split
        and deduped here, and the clean id is written back. The funnel is
        :meth:`_ingest_one`'s and the staging thread's: the halted shed,
        the quarantine shed, then validation (admission governs the raw
        ingest queue; the native core bounds this plane's depth)."""
        g = self.guardrails
        tracer = self._get_tracer()
        t_arr = time.monotonic_ns() if tracer.enabled else 0
        admitted = []
        for item in batch:
            clean_id, seq, ctx, admit = self._admit_seq(item.agent_id)
            if ctx is not None and tracer.enabled:
                # The native core already decoded this payload: the ingest
                # and dedup hops collapse to the drain's arrival.
                tracer.span("traj", ctx.trace_id, "ingest", t_arr, t_arr,
                            agent=clean_id, seq=seq)
                tracer.span("traj", ctx.trace_id, "dedup", t_arr,
                            time.monotonic_ns(), admitted=bool(admit))
                if admit:
                    item.trace_ctx = ctx
            if not admit:
                continue
            self._count_decoded(codec)
            if clean_id != item.agent_id:
                item.agent_id = clean_id
            if g is not None:
                if self._halted:
                    g._m_halted_drops.inc()
                    continue
                if g.quarantine.is_quarantined(clean_id):
                    g.quarantine.count_rejected_send()
                    self._retract(clean_id, seq)
                    continue
                if g.validate(clean_id, item) is None:
                    continue
            admitted.append((item, seq))
        if not admitted:
            return
        try:
            self._decoded.put_nowait([item for item, _ in admitted])
        except queue.Full:
            for item, seq in admitted:
                self._retract(item.agent_id, seq)
            self._count_dropped(len(admitted))

    def _get_model(self) -> tuple[int, bytes]:
        """Current full model as v1 bundle bytes (handshakes, artifact
        writes), serialized lazily from the latest published host tree,
        outside ``_bundle_lock``."""
        with self._bundle_lock:
            host = self._bundle_host
            if host is None or host[0] == self._bundle_version:
                return self._bundle_version, self._bundle_bytes
        ver, arch, params = host
        from relayrl_tpu_torch.types.model_bundle import ModelBundle

        raw = ModelBundle(version=ver, arch=dict(arch),
                          params=params).to_bytes()
        with self._bundle_lock:
            if ver > self._bundle_version:
                self._bundle_bytes = raw
                self._bundle_version = ver
            return self._bundle_version, self._bundle_bytes

    def _get_model_update(self, known_version: int) -> tuple[int, bytes]:
        """Freshest blob a subscriber at ``known_version`` can decode (the
        pull plane's surface): the latest wire frame when its base
        matches (or it is a keyframe), else the full v1 bundle."""
        enc = self._wire_encoder
        if enc is not None:
            got = enc.frame_for(known_version)
            if got is not None:
                return got
        return self._get_model()

    def _on_resync_request(self, held_version: int = -1) -> None:
        """CMD_RESYNC from the broadcast plane: force the next publish to
        keyframe, coalesced and rate-limited."""
        self._m_resync_requests.inc()
        enc = self._wire_encoder
        if enc is None:
            return
        now = time.monotonic()
        with self._resync_lock:
            if now - self._last_resync_grant < self._resync_min_interval_s:
                return
            self._last_resync_grant = now
        enc.force_keyframe()
        self._m_resync_granted.inc()
        from relayrl_tpu_torch import telemetry

        telemetry.emit("resync_keyframe_forced",
                       version=self.latest_model_version)

    @property
    def latest_model_version(self) -> int:
        """Version of the most recently published model."""
        with self._bundle_lock:
            if self._bundle_host is not None:
                return max(self._bundle_version, self._bundle_host[0])
            return self._bundle_version

    def published_digest(self) -> tuple[int, str] | None:
        """``(version, sha256)`` of the latest published params host tree
        (:func:`~relayrl_tpu_torch.weights.tree_digest`), or None before
        the first publish — what an actor at that version must hold bit
        for bit."""
        with self._bundle_lock:
            host = self._bundle_host
        if host is None:
            return None
        from relayrl_tpu_torch.weights import tree_digest

        return host[0], tree_digest(host[2])

    def _on_register(self, agent_id: str) -> None:
        with self._registry_lock:
            fresh = agent_id not in self.agent_ids
            if fresh:
                self.agent_ids.append(agent_id)
        if fresh:
            from relayrl_tpu_torch import telemetry

            telemetry.emit("agent_register", agent_id=agent_id,
                           registered=len(self.agent_ids))

    def _on_unregister(self, agent_id: str) -> None:
        with self._registry_lock:
            try:
                self.agent_ids.remove(agent_id)
            except ValueError:
                return
        from relayrl_tpu_torch import telemetry

        telemetry.emit("agent_unregister", agent_id=agent_id,
                       registered=len(self.agent_ids))

    # -- staging: raw payload -> decoded trajectory (overlaps learner) --
    def _staging_loop(self) -> None:
        from relayrl_tpu_torch.transport.base import BATCH_KIND_FRAMES
        from relayrl_tpu_torch.types.columnar import (
            RawTrajectory,
            is_columnar_frame,
            parse_frame,
        )

        decoder = None
        try:
            from relayrl_tpu_torch.types.columnar import NativeDecoder

            decoder = NativeDecoder()
        except RuntimeError:
            pass  # native codec unavailable: pure-Python decode
        guard = self.guardrails
        while not self._stop.is_set():
            try:
                agent_id, seq, ctx, payload = self._ingest.get(timeout=0.1)
            except queue.Empty:
                continue
            if guard is not None and guard.admission is not None:
                guard.admission.note_dequeued(agent_id)
            item = None
            columnar = False
            t0 = time.monotonic()
            t0_ns = time.monotonic_ns() if ctx is not None else 0
            try:
                if is_columnar_frame(payload):
                    columnar = True
                    item = parse_frame(payload, agent_id=agent_id)
                    self._m_columnar_frames.inc()
                    self._m_columnar_bytes.inc(len(payload))
                    self._count_decoded("columnar")
                elif batch_kind(payload) == BATCH_KIND_FRAMES:
                    # Coalesced columnar segments of one lane: one seq,
                    # N frames.
                    columnar = True
                    parts = split_batch(payload)
                    item = [parse_frame(p, agent_id=agent_id)
                            for p in parts]
                    self._m_columnar_frames.inc(len(parts))
                    self._m_columnar_bytes.inc(len(payload))
                    self._count_decoded("columnar", len(parts))
                elif decoder is not None:
                    # Off-GIL msgpack -> columns; the Python decoder takes
                    # only payloads the columnar schema cannot represent.
                    item = decoder.decode(payload, agent_id=agent_id)
                    if isinstance(item, RawTrajectory):
                        raw = item.payload
                        if item.is_envelope:
                            _, raw = unpack_trajectory_envelope(raw)
                        item = deserialize_actions(raw)
                        self._count_decoded("python")
                    else:
                        self._count_decoded("native")
                else:
                    item = deserialize_actions(payload)
                    self._count_decoded("python")
            except Exception:
                if columnar:
                    self._m_columnar_rejects.inc()
                self._retract(agent_id, seq)
                self._count_dropped()
            if item is not None and guard is not None:
                # Ingest validation + per-agent strikes: the semantic
                # trust boundary, before the decoded item can reach the
                # learner (None = rejected: counted, struck, never
                # trained). Coalesced batches validate per trajectory, so
                # one poisoned segment does not veto its clean siblings.
                if (isinstance(item, list) and item
                        and isinstance(item[0], DecodedTrajectory)):
                    item = [one for one in item
                            if guard.validate(agent_id, one) is not None]
                    if not item:
                        item = None
                else:
                    item = guard.validate(agent_id, item)
            dt = time.monotonic() - t0
            self._m_decode.observe(dt)
            with self._timings_lock:
                self.timings["decode_s"] += dt
            if ctx is not None and item is not None:
                # The staging hop (decode + validate) and the context
                # handoff: the learner attributes the consuming update.
                self._get_tracer().span(
                    "traj", ctx.trace_id, "staging", t0_ns,
                    time.monotonic_ns(), agent=agent_id)
                item = _attach_trace_ctx(item, ctx)
            if item is not None:
                try:
                    self._decoded.put_nowait(item)
                except queue.Full:
                    self._retract(agent_id, seq)
                    self._count_dropped()
            # task_done only after the decoded item is enqueued, so
            # drain()'s two-queue emptiness check never races the handoff
            self._ingest.task_done()

    # -- learner thread --
    def _learner_loop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        if not self._warmup_done.is_set():
            t0 = time.monotonic()
            try:
                n = self.algorithm.warmup(
                    should_continue=lambda: (self._decoded.empty()
                                             and self._ingest.empty()
                                             and not self._stop.is_set()))
                if n:
                    print(f"[TrainingServer] warmup: {n} update shape(s) "
                          f"prepared in {time.monotonic() - t0:.1f}s",
                          flush=True)
            except Exception as e:  # best-effort: the first batch builds
                self._count_learner_error(e, "warmup")
            finally:
                self.timings["warmup_s"] += time.monotonic() - t0
                self._warmup_done.set()
        while not self._stop.is_set():
            t_wait = time.monotonic()
            try:
                item = self._decoded.get(timeout=0.1)
            except queue.Empty:
                self.timings["learner_idle_s"] += time.monotonic() - t_wait
                # Idle is fence-for-free: nothing is queued behind the
                # in-flight updates. Everything dispatched is then
                # fenced, so every pending health probe resolves here.
                self._pipeline_quiesce()
                self._guard_poll()
                continue
            self.timings["learner_idle_s"] += time.monotonic() - t_wait
            if self._halted:
                # Halted (rollback budget spent / no healthy checkpoint):
                # training is stopped; drain and drop so the queues don't
                # grow while the operator digs.
                self.guardrails._m_halted_drops.inc(
                    len(item) if isinstance(item, list) else 1)
                self._decoded.task_done()
                continue
            t0 = time.monotonic()
            try:
                if (isinstance(item, list) and item
                        and isinstance(item[0], DecodedTrajectory)):
                    for one in item:
                        self._process_one(one)
                else:
                    self._process_one(item)
            finally:
                self.timings["learn_s"] += time.monotonic() - t0
                self._decoded.task_done()
        # Shutdown: fence what was dispatched, then resolve its probes,
        # so the signal path's final save is tagged by every update baked
        # into it (a poisoned last update trips here, never tags healthy).
        self._pipeline_quiesce()
        self._guard_poll()

    # -- multi-process learner loop (the lockstep broadcast protocol) --
    # Every process loops in lockstep on a fixed-shape control broadcast:
    # IDLE ticks keep the other processes in step while the coordinator
    # accumulates trajectories; STEP carries the batch's shape, then the
    # batch itself, then every process runs the update on its rows; STOP
    # ends every loop together.
    _MH_IDLE, _MH_STEP, _MH_STOP = 0, 1, 2

    def _mh_accumulate(self, item) -> dict | None:
        """Coordinator: feed one decoded queue entry into the algorithm's
        buffer; returns a ready training batch (at most one per call, the
        rest queue in ``_mh_ready``). The on-policy family yields one epoch
        batch, the off-policy family a list of sampled batches."""
        items = (item if (isinstance(item, list) and item
                          and isinstance(item[0], DecodedTrajectory))
                 else [item])
        for one in items:
            self.stats["trajectories"] += 1
            self._m_trajectories.inc()
            try:
                got = self.algorithm.accumulate(one)
            except Exception as e:
                self._count_learner_error(e, "accumulate")
                continue
            finally:
                self._sync_drop_stats()
            if isinstance(got, list):
                self._mh_ready.extend(got)
            elif got is not None:
                self._mh_ready.append(got)
        return self._mh_ready.pop(0) if self._mh_ready else None

    def _learner_loop_multihost(self) -> None:
        import numpy as np

        from relayrl_tpu_torch.parallel.distributed import (
            broadcast_from_coordinator,
            is_coordinator,
        )

        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        coord = is_coordinator()
        algo = self.algorithm
        while True:
            batch = None
            if coord:
                # STOP pre-empts any ingest backlog: disable_server ends the
                # fleet within one step, not after the queued trajectories.
                if not self._stop.is_set():
                    if self._mh_ready:
                        # Busy before the batch leaves the queues: drain()
                        # checks queues empty AND ready empty AND not busy.
                        self._mh_busy = True
                        batch = self._mh_ready.pop(0)
                    tick_deadline = time.monotonic() + 0.2
                    while batch is None and time.monotonic() < tick_deadline:
                        try:
                            item = self._decoded.get(timeout=0.05)
                        except queue.Empty:
                            continue
                        try:
                            batch = self._mh_accumulate(item)
                            if batch is not None:
                                self._mh_busy = True
                        finally:
                            self._decoded.task_done()
                code = (self._MH_STOP if self._stop.is_set()
                        else self._MH_STEP if batch is not None
                        else self._MH_IDLE)
                desc = np.array(
                    [code,
                     batch["obs"].shape[0] if batch is not None else 0,
                     batch["obs"].shape[1] if batch is not None else 0],
                    np.int64)
            else:
                desc = np.zeros(3, np.int64)
            desc = broadcast_from_coordinator(desc)
            code = int(desc[0])
            if code == self._MH_STOP:
                self._mh_busy = False  # a pre-empted batch is dropped
                # Every process fences what it dispatched and flushes its
                # deferred logs.
                self._pipeline_quiesce()
                break
            if code == self._MH_IDLE:
                # Idle is the place to fence: nothing is queued behind the
                # in-flight updates, and it lets drain() see pending 0.
                self._pipeline_quiesce()
                continue
            if not coord:
                batch = algo.mh_zero_batch(int(desc[1]), int(desc[2]))
            self._mh_busy = True
            batch = broadcast_from_coordinator(batch)
            t0 = time.monotonic()
            try:
                if self._prefetch:
                    batch = algo.stage_batch(batch)
                algo.train_on_batch(batch)
            except Exception as e:
                # Symmetric on every process: the same data fails the same
                # way everywhere, so every loop carries on together.
                self._count_learner_error(e, "multi-host update")
                self._mh_busy = False
                continue
            self.stats["updates"] += 1
            self._m_updates.inc()
            if coord:
                # The epoch log is captured now and dumped once its update
                # is fenced (the coordinator alone logs).
                payload = algo.capture_epoch_stats(True)
                if payload is not None:
                    self._pending_logs.append(
                        (algo.inflight.dispatch_count, payload,
                         algo._last_metrics))
            dispatch_dt = time.monotonic() - t0
            self.timings["dispatch_s"] += dispatch_dt
            self._m_dispatch.observe(dispatch_dt)
            if coord:
                # Only the coordinator owns a transport, so only it
                # publishes (a snapshot here is no collective: every
                # process holds the whole parameters).
                try:
                    if self._publisher is not None:
                        self._publisher.submit(algo.snapshot_for_publish())
                    else:
                        bundle = algo.bundle()
                        self._publish_params(bundle.version, bundle.arch,
                                             bundle.params)
                except Exception as e:
                    self.stats["publish_errors"] += 1
                    print(f"[TrainingServer] publish error: {e!r}", flush=True)
            # Collective: the version mirror advances alike on every
            # process, so every process agrees the save is due.
            self._maybe_periodic_checkpoint(algo.dispatched_version)
            self._flush_ready_logs()
            self._mh_busy = False

    def _count_learner_error(self, exc: Exception, where: str) -> None:
        """The learner thread survives one bad batch, but never silently:
        every caught exception is counted (``stats``, telemetry) and
        printed with its traceback."""
        self.stats["learner_errors"] += 1
        self.last_learner_error = f"{where}: {exc!r}"
        self._m_learner_errors.inc()
        print(f"[TrainingServer] learner error ({where}): {exc!r}\n"
              f"{traceback.format_exc()}", flush=True)

    def _sync_drop_stats(self) -> None:
        self.stats["dropped_nonfinite"] = getattr(
            self.algorithm, "dropped_nonfinite", 0)
        self._m_nonfinite.set(self.stats["dropped_nonfinite"])

    def _process_one(self, item) -> None:
        """``item``: DecodedTrajectory or list[ActionRecord].
        Dispatch-only: the update enters the algorithm's in-flight window
        unfenced, the publish is handed to the latest-wins publisher
        thread, and the epoch log defers until the update's fence."""
        algo = self.algorithm
        if not hasattr(algo, "accumulate"):
            self._process_one_legacy(item)
            return
        self.stats["trajectories"] += 1
        self._m_trajectories.inc()
        ctx = getattr(item, "trace_ctx", None)
        if ctx is not None:
            self._trace_pending.append(ctx)
        self._observe_behavior_lag(item, algo, ctx)
        tracer = self._get_tracer()
        t0_ns = time.monotonic_ns() if tracer.enabled else 0
        # The version this batch trains FROM (pre-dispatch): the
        # convention of _observe_behavior_lag's histogram, so the
        # trace-side version-lag distribution matches it exactly.
        consume_ver = algo.dispatched_version if tracer.enabled else 0
        t0 = time.monotonic()
        try:
            got = algo.accumulate(item)
            updated = got is not None
            if updated:
                # The off-policy family returns the list of batches due;
                # the on-policy family one drained epoch batch.
                batches = got if isinstance(got, list) else [got]
                if self._prefetch:
                    # Every host-to-device copy is queued now, ahead of
                    # the updates that read them.
                    batches = [algo.stage_batch(b) for b in batches]
                if isinstance(got, list):
                    algo.train_on_batches(batches)
                else:
                    algo.train_on_batch(batches[0])
        except Exception as e:  # never kill the loop on one bad batch
            self._count_learner_error(e, "update")
            return
        finally:
            self._sync_drop_stats()
        if (updated and self.guardrails is not None
                and self.guardrails.watchdog is not None):
            # Queue the dispatched update's lazy metrics, probe scalars
            # included, for the watchdog; they resolve at the in-flight
            # fence, never here.
            self.guardrails.watchdog.observe_dispatch(
                algo.inflight.dispatch_count, algo._last_metrics)
        payload = algo.capture_epoch_stats(updated)
        if payload is not None:
            self._pending_logs.append(
                (algo.inflight.dispatch_count, payload, algo._last_metrics))
        dispatch_dt = time.monotonic() - t0
        self.timings["dispatch_s"] += dispatch_dt
        self._m_dispatch.observe(dispatch_dt)
        if tracer.enabled and updated:
            self._trace_dispatch(tracer, algo, t0_ns, consume_ver)
        if updated:
            self.stats["updates"] += 1
            self._m_updates.inc()
            try:
                if self._publisher is not None:
                    self._publisher.submit(algo.snapshot_for_publish())
                    self._maybe_periodic_checkpoint(algo.dispatched_version)
                else:
                    self._publish()
            except Exception as e:  # transient socket/fs errors
                self.stats["publish_errors"] += 1
                print(f"[TrainingServer] publish error: {e!r}", flush=True)
        self._flush_ready_logs()
        self._guard_poll()

    def _observe_behavior_lag(self, item, algo, ctx=None) -> None:
        """RLHF-plane off-policy evidence: a trajectory whose records carry
        ``bver`` (the params version its generation sampled under, stamped
        per token by ``rlhf/scheduler.py``) observes ``dispatched_version -
        bver`` into the train-lag histogram, once per trajectory. A sampled
        trace context's born version (stamped at emission) is the same
        kind of evidence, so bver-less traced trajectories feed the
        histogram too: the analyzer's version-lag distribution and this
        histogram then describe the same data. Untraced non-RLHF traffic
        pays one dict lookup."""
        try:
            if isinstance(item, DecodedTrajectory):
                arr = (item.aux or {}).get("bver")
                if arr is None or len(arr) == 0:
                    self._observe_ctx_lag(algo, ctx)
                    return
                bver = int(arr.reshape(-1)[0])
            else:
                data = item[0].data if item else None
                if not data or "bver" not in data:
                    self._observe_ctx_lag(algo, ctx)
                    return
                bver = int(data["bver"])
            self._m_rlhf_train_lag.observe(max(0, algo.dispatched_version - bver))
        except Exception:
            # Lag evidence is diagnostics; malformed aux must never touch
            # the ingest path's health.
            pass

    def _observe_ctx_lag(self, algo, ctx) -> None:
        if ctx is not None and ctx.born_version >= 0:
            self._m_rlhf_train_lag.observe(
                max(0, algo.dispatched_version - ctx.born_version))

    def _trace_dispatch(self, tracer, algo, t0_ns: int,
                        consume_ver: int) -> None:
        """Close out the tracing of one update dispatch (learner thread):
        the downstream ``dispatch`` hop for a sampled version, and for
        every sampled trajectory context consumed since the previous
        dispatch the upstream ``update`` hop plus the data-age and
        version-lag observations (skew-guarded: a cross-host born stamp
        is dropped, never observed)."""
        from relayrl_tpu_torch.telemetry.trace import (
            SKEW_GUARD_NS,
            model_trace_id,
        )

        t1_ns = time.monotonic_ns()
        ver = algo.dispatched_version
        if tracer.sample_version(ver):
            tracer.span("model", model_trace_id(ver), "dispatch",
                        t0_ns, t1_ns, version=int(ver))
        while self._trace_pending:
            ctx = self._trace_pending.popleft()
            # version = the version the batch trained FROM.
            tracer.span("traj", ctx.trace_id, "update", t0_ns, t1_ns,
                        version=int(consume_ver))
            age_ns = t1_ns - ctx.born_ns
            if 0 <= age_ns < SKEW_GUARD_NS:
                lag = (int(consume_ver) - ctx.born_version
                       if ctx.born_version >= 0 else None)
                tracer.observe_data_age(age_ns / 1e9, lag)

    def _process_one_legacy(self, item) -> None:
        """Plugin algorithms with only the reference contract: train and
        log inside receive_trajectory, publish synchronously."""
        self.stats["trajectories"] += 1
        self._m_trajectories.inc()
        try:
            updated = self.algorithm.receive_trajectory(item)
        except Exception as e:
            self._count_learner_error(e, "receive_trajectory")
            return
        finally:
            self._sync_drop_stats()
        if updated:
            self.stats["updates"] += 1
            self._m_updates.inc()
            try:
                self._publish()
            except Exception as e:
                self.stats["publish_errors"] += 1
                print(f"[TrainingServer] publish error: {e!r}", flush=True)
            self._poll_tensorboard()

    def _poll_tensorboard(self) -> None:
        """Tail the epoch log into TensorBoard (``tensorboard=True``);
        a writer error is printed, never raised into the learner."""
        if self._tb is not None:
            try:
                self._tb.poll()
            except Exception as e:
                print(f"[TrainingServer] tensorboard error: {e!r}",
                      flush=True)

    def _flush_ready_logs(self, force: bool = False) -> None:
        """Dump deferred epoch logs whose update has been fenced (FIFO).
        Learner thread only."""
        win = self.algorithm.inflight
        dumped = False
        while self._pending_logs:
            after_dispatch, payload, metrics = self._pending_logs[0]
            if not force and after_dispatch > win.fenced_count:
                break
            self._pending_logs.popleft()
            try:
                self.algorithm.log_epoch(stats=payload, metrics=metrics)
                dumped = True
            except Exception as e:
                self._count_learner_error(e, "log_epoch")
        if dumped:
            self._poll_tensorboard()
        self.timings["device_wait_s"] = win.device_wait_s
        if self._publisher is not None:
            self.timings["publish_s"] = self._publisher.publish_s

    def _pipeline_quiesce(self) -> None:
        """Fence every in-flight update and flush the deferred logs
        (learner thread only)."""
        win = getattr(self.algorithm, "_inflight", None)
        if win is not None and win.pending:
            win.drain()
        if self._pending_logs:
            self._flush_ready_logs(force=True)

    # -- divergence watchdog + last-known-good rollback (learner thread) --
    def _guard_poll(self) -> bool:
        """Resolve fenced health probes and run the watchdog's detectors;
        a trip executes the rollback (or the halt). True when a trip
        fired — a checkpoint gated on health skips its save then."""
        g = self.guardrails
        if (g is None or g.watchdog is None or self._halted
                or self.distributed_info["multi_host"]):
            # Multi-process: the rollback restores a checkpoint, a
            # collective that a trip on one process alone would hang.
            return False
        win = getattr(self.algorithm, "_inflight", None)
        fenced = win.fenced_count if win is not None else 0
        trip = g.watchdog.poll(fenced)
        if trip is None:
            return False
        self._execute_rollback(trip)
        return True

    def _execute_rollback(self, trip) -> None:
        """The watchdog tripped: fence everything in flight, restore the
        newest healthy-tagged checkpoint (params and Adam state, in place)
        and its dedup-ledger sidecar, fast-forward the version past the
        poisoned line, force a model-wire keyframe, publish the restored
        params, and resume. More than ``max_rollbacks`` inside
        ``rollback_window_s`` (or no healthy checkpoint) halts instead.
        Learner thread only: nothing else dispatches while this runs."""
        from relayrl_tpu_torch import telemetry

        g = self.guardrails
        # 1. Halt dispatch: drain the in-flight window (its CUDA events
        # fence every update the restore is about to overwrite), drop the
        # deferred logs (the rolled-back line's), and let the publisher
        # finish so no poisoned-line publish races the restored one.
        win = getattr(self.algorithm, "_inflight", None)
        if win is not None and win.pending:
            win.drain()
        self._pending_logs.clear()
        if self._publisher is not None:
            self._publisher.drain(timeout=30.0)
        if not g.params["rollback"] or not self._checkpoint_dir:
            self._enter_halt(trip, "rollback disabled")
            return
        now = time.monotonic()
        window = g.params["rollback_window_s"]
        self._rollback_times = [t for t in self._rollback_times
                                if now - t < window]
        if len(self._rollback_times) >= g.params["max_rollbacks"]:
            self._enter_halt(trip, "rollback budget spent")
            return
        self._rollback_times.append(now)
        # The poisoned line's newest version, dispatched or published.
        poisoned_version = max(self.latest_model_version,
                               int(self.algorithm.dispatched_version))
        # 2. Restore the newest healthy step.
        try:
            from relayrl_tpu_torch.checkpoint import restore_latest_healthy

            step = restore_latest_healthy(self.algorithm,
                                          self._checkpoint_dir)
        except FileNotFoundError:
            self._enter_halt(trip, "no healthy checkpoint retained")
            return
        except Exception as e:
            self._enter_halt(trip, f"restore failed: {e!r}")
            return
        # 3. The dedup ledger must match the restored params' line of
        # history: a newer ledger would dedup (lose) trajectories whose
        # updates just rolled back.
        self._load_ledger_sidecar(step)
        # 4. Fast-forward the version past anything the poisoned line
        # dispatched or published, so actor swap gates and checkpoint
        # steps stay monotonic. (The JAX server counts what was published
        # and the restored step, so the version of an update whose publish
        # the gate blocked is reused there; here it never is.)
        new_version = poisoned_version + 1
        self.algorithm.force_version(new_version)
        # 5. Host-side ingest state part-filled by the poisoned stream
        # belongs to the rolled-back line.
        self.algorithm.reset_ingest_buffers()
        # 6. Re-arm BEFORE the publish below: its checkpoint due-check
        # re-enters _guard_poll, and a watchdog still holding
        # poisoned-line probes would recurse straight back into rollback.
        g.watchdog.reset_after_rollback()
        self._ckpt_version = new_version
        self._artifact_version = new_version
        # 7. Forced keyframe + immediate publish: every actor resyncs to
        # the restored params whatever deltas it held.
        if self._wire_encoder is not None:
            self._wire_encoder.force_keyframe()
        try:
            self._publish()
        except Exception as e:
            self.stats["publish_errors"] += 1
            print(f"[TrainingServer] rollback publish error: {e!r}",
                  flush=True)
        self._rollbacks_total += 1
        g._m_rollbacks.inc()
        telemetry.emit("rollback", signal=trip.signal, value=trip.value,
                       threshold=trip.threshold, restored_step=int(step),
                       new_version=int(new_version),
                       attempt=len(self._rollback_times))
        print(f"[TrainingServer] ROLLBACK #{self._rollbacks_total}: "
              f"{trip.signal} tripped → restored healthy step {step}, "
              f"resuming as version {new_version}", flush=True)

    def _enter_halt(self, trip, reason: str) -> None:
        """Degrade to halt-and-alarm: training stops, ingest sheds, the
        process stays up for inspection. One-way until a restart."""
        from relayrl_tpu_torch import telemetry

        self._halted = True
        self.guardrails._m_halted.set(1)
        telemetry.emit("guardrails_halt", signal=trip.signal,
                       value=trip.value, reason=reason,
                       rollbacks=self._rollbacks_total)
        print(f"[TrainingServer] GUARDRAILS HALT ({reason}): "
              f"{trip.signal} tripped and recovery is exhausted — "
              f"training stopped, ingest shedding, process alive for "
              f"inspection", flush=True)

    @property
    def guardrails_halted(self) -> bool:
        return self._halted

    def guardrails_accounting(self) -> dict:
        """Validation, quarantine, watchdog and admission accounting plus
        the server's rollback/halt ledger. Empty when disabled."""
        g = self.guardrails
        if g is None:
            return {}
        out = g.accounting()
        out["rollbacks_total"] = self._rollbacks_total
        out["halted"] = self._halted
        return out

    def _learner_pending(self) -> int:
        """Dispatched-but-unfenced updates + deferred logs + queued or
        in-progress publishes."""
        win = getattr(self.algorithm, "_inflight", None)
        n = (win.pending if win is not None else 0) + len(self._pending_logs)
        if self._publisher is not None:
            n += self._publisher.pending
        return n

    def drain(self, timeout: float = 60.0) -> bool:
        """Block until every trajectory already received has been
        processed: dispatched updates fenced, deferred logs dumped, and
        the final (latest-wins) publish landed. True if drained within
        ``timeout``. Bytes still in socket buffers are invisible here."""
        from relayrl_tpu_torch import telemetry

        t0 = time.monotonic()
        deadline = t0 + timeout
        while time.monotonic() < deadline:
            if (self._ingest.unfinished_tasks == 0
                    and self._decoded.unfinished_tasks == 0
                    and self._learner_pending() == 0
                    # multi-process: assembled-but-untrained batches and
                    # the broadcast step in flight are pending too
                    and not self._mh_ready
                    and not self._mh_busy):
                self._flush_drop_event()
                telemetry.emit("drain",
                               wait_s=round(time.monotonic() - t0, 3),
                               updates=self.stats["updates"])
                return True
            time.sleep(0.05)
        return False

    # -- idempotent-ingest ledger persistence --
    def _ledger_sidecar_path(self, version: int) -> str:
        return os.path.join(self._checkpoint_dir,
                            f"ingest_ledger_{int(version)}.json")

    def _save_ledger_sidecar(self, version: int) -> None:
        """Snapshot the dedup ledger beside the checkpoint at ``version``
        (atomic write; older sidecars pruned to the retention depth),
        keyed by version so a resume restores the dedup state consistent
        with the restored params."""
        if (self._ingest_ledger is None or not self._checkpoint_dir
                or self.transport is None):
            return  # the ledger is the coordinator's: it alone ingests
        try:
            self._ingest_ledger.save(self._ledger_sidecar_path(version))
            import glob

            sidecars = sorted(
                glob.glob(os.path.join(self._checkpoint_dir,
                                       "ingest_ledger_*.json")),
                key=lambda p: int(p.rsplit("_", 1)[1].split(".")[0]))
            for stale in sidecars[:-max(2, self._ckpt_keep)]:
                os.remove(stale)
        except (OSError, ValueError) as e:
            print(f"[TrainingServer] ingest-ledger sidecar write failed: "
                  f"{e!r}", flush=True)

    def _load_ledger_sidecar(self, version: int) -> None:
        if self._ingest_ledger is None or not self._checkpoint_dir:
            return
        path = self._ledger_sidecar_path(version)
        try:
            from relayrl_tpu_torch.runtime.spool import SequenceLedger

            self._ingest_ledger = SequenceLedger.load(path)
            print(f"[TrainingServer] ingest ledger restored "
                  f"({len(self._ingest_ledger.counts())} agent(s), "
                  f"version {version})", flush=True)
        except FileNotFoundError:
            print(f"[TrainingServer] no ingest-ledger sidecar at version "
                  f"{version}; dedup starts empty (replays of "
                  f"already-trained trajectories will re-train)",
                  flush=True)
        except (OSError, ValueError, KeyError) as e:
            print(f"[TrainingServer] ingest-ledger sidecar unreadable: "
                  f"{e!r}; dedup starts empty", flush=True)

    def ingest_accounting(self) -> dict:
        """Per-agent ``{max_seq, accepted, contiguous}`` + duplicate
        count. Empty when dedup is disabled."""
        if self._ingest_ledger is None:
            return {"agents": {}, "duplicates": 0}
        return {"agents": self._ingest_ledger.counts(),
                "duplicates": self._ingest_ledger.total_duplicates()}

    def _write_model_artifact(self, version: int) -> None:
        """Distance-gated on-disk model bytes (a resume/debug aid)."""
        if version - self._artifact_version < self._checkpoint_every:
            return
        raw = self._get_model()[1]
        try:
            path = self.algorithm.server_model_path
            tmp = f"{path}.tmp"
            with open(tmp, "wb") as f:
                f.write(raw)
            os.replace(tmp, path)
            self._artifact_version = version
        except OSError:
            pass

    def _publish_params(self, version: int, arch: dict, host_params) -> None:
        """The one broadcast path: a model-wire v2 keyframe or delta frame
        (or the v1 bundle under ``transport.wire_version: 1``)."""
        from relayrl_tpu_torch import telemetry
        from relayrl_tpu_torch.guardrails.validate import params_tree_finite

        g = self.guardrails
        if g is not None and not params_tree_finite(host_params):
            # The publish gate: non-finite params never reach the wire,
            # the handshake cache or the artifact file; the fleet keeps
            # the last good model while the watchdog's rollback replaces
            # the poisoned line (trip_external surfaces on the learner
            # thread's next poll).
            g._m_publish_blocked.inc()
            if g.watchdog is not None:
                g.watchdog.trip_external("publish_nonfinite",
                                         float("nan"), 0.0)
            telemetry.emit("publish_blocked", version=int(version))
            print(f"[TrainingServer] publish BLOCKED: version {version} "
                  f"params are non-finite", flush=True)
            return
        enc = self._wire_encoder
        host = (int(version), dict(arch), host_params)
        tracer = self._get_tracer()
        traced = tracer.enabled and tracer.sample_version(version)
        try:
            if enc is not None:
                # The encoder holds this version's frame before the
                # version probe (latest_model_version, read from
                # _bundle_host) moves: a pull subscriber it wakes is then
                # served that frame, never a full v1 bundle of a version
                # the encoder has not reached yet.
                t_enc0 = time.monotonic_ns() if traced else 0
                frame, info = enc.encode(version, arch, host_params)
                if traced:
                    from relayrl_tpu_torch.telemetry.trace import (
                        model_trace_id,
                    )

                    tracer.span("model", model_trace_id(version), "encode",
                                t_enc0, time.monotonic_ns(),
                                version=int(version), frame_kind=info["kind"],
                                bytes=info["frame_bytes"])
                with self._bundle_lock:
                    self._bundle_host = host
                if getattr(self.transport, "needs_handshake_bytes", False):
                    # The native core answers handshakes from pushed
                    # bytes; a v2 publish rides with the v1 bundle for
                    # set_model.
                    self._traced_wire_publish(
                        traced, version, frame,
                        handshake_bytes=self._get_model()[1])
                else:
                    self._traced_wire_publish(traced, version, frame)
                telemetry.emit("model_publish", version=version,
                               bytes=info["frame_bytes"], kind=info["kind"],
                               raw_bytes=info["raw_bytes"])
                self.last_publish = info
            else:
                from relayrl_tpu_torch.types.model_bundle import ModelBundle

                raw = ModelBundle(version=int(version), arch=dict(arch),
                                  params=host_params).to_bytes()
                with self._bundle_lock:
                    self._bundle_host = host
                    self._bundle_bytes = raw
                    self._bundle_version = int(version)
                self._traced_wire_publish(traced, version, raw)
                telemetry.emit("model_publish", version=version,
                               bytes=len(raw))
                self.last_publish = {"kind": "v1", "frame_bytes": len(raw)}
            self.publish_bytes[self.last_publish["kind"]].append(
                self.last_publish["frame_bytes"])
        finally:
            self._write_model_artifact(version)
            # Colocated serving feed: the inference plane sees every
            # published version straight from the host tree, behind the
            # same finite-publish gate as the fleet, once the version
            # probe has moved.
            if self.inference is not None:
                try:
                    self.inference.install_params(version, arch, host_params)
                except Exception as e:
                    print(f"[TrainingServer] serving install error: {e!r}",
                          flush=True)

    def _traced_wire_publish(self, traced: bool, version: int,
                             frame: bytes, **kwargs) -> None:
        """The ``publish`` hop span (socket broadcast wall time on the
        publisher thread) around the fault-site-wrapped broadcast."""
        if not traced:
            self._faulted_publish(version, frame, **kwargs)
            return
        from relayrl_tpu_torch.telemetry.trace import model_trace_id

        t0 = time.monotonic_ns()
        try:
            self._faulted_publish(version, frame, **kwargs)
        finally:
            self._get_tracer().span(
                "model", model_trace_id(version), "publish", t0,
                time.monotonic_ns(), version=int(version),
                backend=self.server_type)

    def _faulted_publish(self, version: int, frame: bytes,
                         **kwargs) -> None:
        """Model broadcast through the ``server.publish`` fault site."""
        if self._fault_publish is None:
            self.transport.publish_model(version, frame, **kwargs)
            return
        for delay_s, part in self._fault_publish.inject(frame):
            if delay_s > 0:
                time.sleep(delay_s)
            self.transport.publish_model(version, part, **kwargs)

    def _publish(self) -> None:
        """Synchronous publish on the learner thread (the
        ``async_publish: false`` escape hatch)."""
        bundle = self.algorithm.bundle()
        self._publish_params(bundle.version, bundle.arch, bundle.params)
        self._maybe_periodic_checkpoint(bundle.version)

    def _maybe_periodic_checkpoint(self, version: int) -> None:
        """Distance-gated full-state checkpoint. Quiesces the pipeline
        first, so the checkpointed epoch counter is in step with the
        checkpointed params."""
        if (not self._checkpoint_dir
                or version - self._ckpt_version < self._checkpoint_every):
            return
        self._pipeline_quiesce()
        # Post-quiesce every pending probe resolves for free: a trip
        # rolls back (the save is skipped: it would capture the poisoned
        # line), and a clean poll makes the healthy-at-save tag honest.
        if self._guard_poll():
            return
        self._periodic_checkpoint()
        self._ckpt_version = version

    def _publish_snapshot(self, snapshot) -> None:
        """Publisher-thread body: the device-to-host read (after the
        snapshot's event), wire encode and socket publish."""
        self._publish_params(snapshot.version, snapshot.arch,
                             snapshot.host_params())

    def _health_tag(self) -> dict:
        """The healthy-at-save tag every checkpoint carries: True iff the
        watchdog's most recently resolved probes were clean (none still
        pending, no trip unpolled) and the server is not halted. The
        periodic path quiesces and polls before saving, so a True tag
        means every update baked into the step had its probes resolved
        clean: the last-known-good ring's membership test
        (``restore_latest_healthy``). Guardrails or watchdog off ⇒ True,
        so the ring stays usable as a plain resume source."""
        g = self.guardrails
        healthy = not self._halted and (
            g is None or g.watchdog is None or g.watchdog.healthy())
        return {"healthy": healthy}

    def _periodic_checkpoint(self) -> None:
        try:
            from relayrl_tpu_torch.checkpoint import checkpoint_algorithm

            include_aux = self._ckpt_saves % self._aux_every == 0
            checkpoint_algorithm(self.algorithm, self._checkpoint_dir,
                                 include_aux=include_aux,
                                 max_to_keep=self._ckpt_keep,
                                 extra_meta=self._health_tag())
            from relayrl_tpu_torch import telemetry

            telemetry.emit("checkpoint", version=self.algorithm.version,
                           include_aux=include_aux,
                           dir=str(self._checkpoint_dir))
            self._save_ledger_sidecar(self.algorithm.version)
            self._ckpt_saves += 1
            if self._ckpt_consecutive_failures:
                self._ckpt_consecutive_failures = 0
                self._m_ckpt_consecutive.set(0)
        except Exception as e:
            if type(e).__name__ == "StepAlreadyExistsError":
                print("[TrainingServer] checkpoint step exists, skipped "
                      "(post-resume overlap with a bumped final save)",
                      flush=True)
            else:
                self._ckpt_consecutive_failures += 1
                self._m_ckpt_failures.inc()
                self._m_ckpt_consecutive.set(
                    self._ckpt_consecutive_failures)
                from relayrl_tpu_torch import telemetry

                telemetry.emit(
                    "checkpoint_failed", version=self.algorithm.version,
                    error=repr(e),
                    consecutive=self._ckpt_consecutive_failures,
                    dir=str(self._checkpoint_dir))
                print(f"[TrainingServer] checkpoint failed "
                      f"(#{self._ckpt_consecutive_failures} consecutive): "
                      f"{e!r}", flush=True)

    # -- fleet telemetry tick --
    def _fleet_loop(self) -> None:
        while not self._fleet_stop.wait(self._fleet_interval_s):
            self._fleet_tick()

    def _fleet_tick(self) -> None:
        """One aggregation interval at the root: fold this server's own
        registry into the table, evict stale procs, evaluate the SLO rules
        over the merged snapshot. Isolated: the pane never takes down the
        plane it watches."""
        from relayrl_tpu_torch import telemetry

        try:
            self._fleet.ingest_registry(self._telemetry, self._fleet_proc,
                                        "server")
            for proc in self._fleet.sweep():
                telemetry.emit("fleet_evict", proc=proc)
            if self._alerts is not None:
                # Membership rides along so increase rules rebaseline
                # across evict/rejoin churn instead of firing on it.
                self._alerts.evaluate(
                    self._fleet.merged(),
                    membership=[p["proc"] for p in self._fleet.procs()])
        except Exception as e:
            print(f"[TrainingServer] fleet tick failed: {e!r}", flush=True)

    # -- lifecycle --
    def enable_server(self) -> None:
        if self.active:
            return
        self._stop.clear()
        multi_host = self.distributed_info["multi_host"]
        if self.transport is not None:
            self.transport.start()
            self._staging_threads = [
                threading.Thread(target=self._staging_loop,
                                 name=f"ingest-staging-{i}", daemon=True)
                for i in range(self._staging_count)]
            for t in self._staging_threads:
                t.start()
        if self.inference is not None:
            self.inference.start()
        # The publisher exists wherever a transport feeds: the other
        # processes of a multi-process learner own no actor plane.
        if (self.transport is not None and self._async_publish
                and self._publisher is None):
            from relayrl_tpu_torch.runtime.pipeline import ModelPublisher

            self._publisher = ModelPublisher(self._publish_snapshot)
        self._mh_ready = []
        self._mh_busy = False
        if multi_host:
            # The update is collective: a warmup on one process alone would
            # hang the others, so wait_warmup() must not block.
            self._warmup_done.set()
        self._learner_thread = threading.Thread(
            target=(self._learner_loop_multihost if multi_host
                    else self._learner_loop),
            name="learner", daemon=True)
        self._learner_thread.start()
        if self._fleet is not None:
            self._fleet_stop.clear()
            self._fleet_thread = threading.Thread(
                target=self._fleet_loop, name="fleet-tick", daemon=True)
            self._fleet_thread.start()
        self.active = True

    def wait_warmup(self, timeout: float | None = None) -> bool:
        """Block until the learner thread has finished its warmup. False
        immediately when the server isn't running."""
        if not self.active and not self._warmup_done.is_set():
            return False
        return self._warmup_done.wait(timeout)

    def disable_server(self, join_timeout: float | None = None) -> None:
        if not self.active:
            return
        self._stop.set()
        if self._fleet_thread is not None:
            self._fleet_stop.set()
            self._fleet_thread.join(timeout=5)
            self._fleet_thread = None
            # One closing tick so the table holds this life's final
            # registry state (and the alerts a last look) before the
            # ingest plane stops feeding it.
            self._fleet_tick()
        # Serving plane first: parked thin-client requests answer with a
        # retryable nack instead of hanging out their timeouts against a
        # closing socket.
        if self.inference is not None:
            self.inference.stop()
        deadline = (None if join_timeout is None
                    else time.monotonic() + join_timeout)

        def remaining(default):
            return (default if deadline is None
                    else max(0.0, deadline - time.monotonic()))

        for t in self._staging_threads:
            t.join(timeout=remaining(30))
        self._staging_threads = []
        # The learner joins BEFORE the transport stops: a trajectory being
        # processed right now may still publish. Multi-process: the
        # coordinator's learner thread broadcasts STOP on its way out,
        # releasing every other process's loop (shut the processes down
        # together, or the coordinator last), and a step in flight may take
        # a while to reach it.
        if self._learner_thread is not None:
            self._learner_thread.join(timeout=remaining(
                600 if self.distributed_info["multi_host"] else 30))
            self._learner_thread = None
        if self._publisher is not None:
            self._publisher.stop(timeout=remaining(30))
            self._publisher = None
        if self.transport is not None:
            self.transport.stop()
        self._flush_drop_event()
        self.active = False

    def restart_server(self, **addr_overrides) -> None:
        self.disable_server()
        # The other processes of a multi-process learner never own a
        # transport: a restart called on every process makes none there.
        if addr_overrides and self.transport is not None:
            self._addr_overrides.update(addr_overrides)
            self._make_transport()
            if self.inference is not None:
                self._wire_serving_plane(self._addr_overrides)
        self.enable_server()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.disable_server()


def _coerce(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    return v


def _load_plugin_algorithms(algorithm_dir: str) -> None:
    """Import ``<dir>/<ALGO>/<ALGO>.py`` modules so they can
    ``register_algorithm`` themselves."""
    import importlib.util
    import sys

    if algorithm_dir not in sys.path:
        sys.path.insert(0, algorithm_dir)
    for entry in sorted(os.listdir(algorithm_dir)):
        mod_file = os.path.join(algorithm_dir, entry, f"{entry}.py")
        if os.path.isfile(mod_file):
            name = f"relayrl_plugin_{entry}"
            if name in sys.modules:
                continue
            spec = importlib.util.spec_from_file_location(name, mod_file)
            module = importlib.util.module_from_spec(spec)
            sys.modules[name] = module
            spec.loader.exec_module(module)


__all__ = ["TrainingServer", "registered_algorithms"]
