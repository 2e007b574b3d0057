"""Disaggregated batched-inference serving plane.

Counterpart of :mod:`relayrl_tpu.runtime.inference`.

Every actor tier holds its own policy replica and swaps full params — the
right shape for rollout throughput, the wrong one for a wide, stateless,
latency-bound serving fleet. TorchBeast (arXiv:1910.03552) showed the
answer is a **dynamic-batching inference server**: accept observation
requests, close a batch on a size-or-deadline trigger, run ONE batched
policy step, and stream the actions back; Podracer's Sebulba split
(arXiv:2104.06272) colocates that service with the learner devices so
actors become near-stateless thin clients.

This module is both halves:

* :class:`InferenceService` — the latency-bounded dynamic-batching queue
  plus ONE batched policy dispatch per closed batch: the keyed batched
  steps (``make_keyed_batched_step`` / ``make_keyed_batched_window_step``,
  the compositions every other actor tier runs, with each row's noise and
  successor key drawn from that row's key alone), so a served action
  equals the keyed step called locally on the same key, observation or
  window and bucket, bit for bit. Batch shapes are bucketed
  (``pick_bucket`` over ``serving.buckets``) and padded rows are sliced off
  before replies. The service serves the latest installed params
  version: params are read ONCE per batch under the shared swap gate
  (``apply_bundle_swap``), so a batch is single-version by construction
  even against a racing swapper; every install builds a new params
  object, so a dispatch in flight keeps the one it read. Overload (queue
  at ``serving.queue_limit``) answers with a typed ``NACK_OVERLOADED`` +
  retry-after instead of queueing unboundedly.

* :class:`RemoteActorClient` — the thin-client actor: no params, no model
  subscription, no swap gate; just a request/response loop carrying its
  key (``uint32[2]``, the words ``jax.random.PRNGKey(seed)`` gives, so a
  JAX client and a port client interoperate with either service). The
  trajectory plane — Trajectory assembly, spool/seq tagging, transport
  envelopes — is byte-identical to a local actor's.

Colocated mode: the TrainingServer feeds :meth:`InferenceService.install_params`
from its publish path in-process. Standalone mode:
:class:`StandaloneInferenceHost` subscribes over any agent transport like
an actor would and hosts the same service.

With tracing on, a sampled request records the ``serve`` plane's
``queue`` and ``dispatch`` spans, and a thin client's episodes draw
trajectory trace contexts as an agent's do; with the fleet plane on, the
thin clients ship their registry snapshots like agents.
"""

from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np

from relayrl_tpu_torch.data.batching import pick_bucket
from relayrl_tpu_torch.transport.base import (
    NACK_OK,
    NACK_OVERLOADED,
    NACK_UNAVAILABLE,
)
from relayrl_tpu_torch.transport.serving import (
    pack_action_reply,
    pack_infer_nack,
    pack_infer_request,
    pack_infer_wave,
    pack_reply_wave,
    unpack_infer_any,
)
from relayrl_tpu_torch.runtime.policy_actor import push_window
from relayrl_tpu_torch.types.action import ActionRecord
from relayrl_tpu_torch.types.model_bundle import ModelBundle, exploration_kwargs
from relayrl_tpu_torch.types.trajectory import Trajectory

CLOSE_SIZE = "size"
CLOSE_DEADLINE = "deadline"


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s words as ``uint32[2]``: the high and
    low 32 bits of ``seed`` (``[0, seed]`` below 2**32) — the key a thin
    client starts from, so JAX and port clients interoperate."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    np.uint32)


class InferRequest:
    """One queued observation request (decoded, transport-agnostic).
    ``sid``/``rst``/``stp``/``win`` are the serving-v2 session fields
    (None/False/0 on the v1 stateless wire); ``window_row``/``window_t``
    are filled by the batch worker once the session table resolves the
    request into a dispatchable window row."""

    __slots__ = ("agent_id", "req_id", "key", "obs", "mask", "reply",
                 "t_enqueue", "trace", "t_enqueue_ns", "wave",
                 "sid", "rst", "stp", "win", "window_row", "window_t")

    def __init__(self, agent_id, req_id, key, obs, mask, reply,
                 sid=None, rst=False, stp=0, win=None, wave=False):
        self.agent_id = agent_id
        self.req_id = req_id
        self.key = key
        self.obs = obs
        self.mask = mask
        self.reply = reply
        # Wave-arrived requests share one reply pipe; served actions for
        # batchmates from the same wave leave as one coalesced frame.
        self.wave = wave
        self.sid = sid
        self.rst = rst
        self.stp = stp
        self.win = win
        self.window_row = None
        self.window_t = 0
        self.t_enqueue = time.monotonic()
        # Distributed tracing (telemetry/trace.py): a sampled request
        # draws a serve-plane trace id at submit; its queue and dispatch
        # hops record at batch execution.
        self.trace = None
        self.t_enqueue_ns = 0


class _Session:
    """Server-side per-session serving state for sequence policies: the
    rolling observation window a transformer serves from, so the client
    never ships context with a step. Reconstructible-from-client by
    contract (the resync payload), so losing one — LRU eviction, TTL
    expiry, replica death — costs a resync round-trip, never an episode.
    ``episode_step`` is the push-idempotency cursor (see
    ``pack_infer_request``'s ``stp``)."""

    __slots__ = ("window", "length", "episode_step", "last_used")

    def __init__(self, ctx: int, obs_dim: int, now: float):
        self.window = np.zeros((ctx, obs_dim), np.float32)
        self.length = 0
        self.episode_step = 0
        self.last_used = now


def default_buckets(max_batch: int) -> list[int]:
    """Powers of two up to ``max_batch`` (inclusive, deduped): at most
    ~log2(max_batch) dispatch shapes serve every occupancy."""
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(int(max_batch))
    return sorted(set(out))


class InferenceService:
    """Latency-bounded dynamic-batching policy server.

    Requests accumulate until ``max_batch`` arrivals (close reason
    ``size``) or ``batch_timeout_ms`` after the FIRST queued request of
    the batch (close reason ``deadline``), whichever fires first — the
    TorchBeast batching-server contract. ``queue_limit`` bounds waiting
    requests; beyond it submissions nack ``NACK_OVERLOADED`` with
    ``retry_after_s`` so clients back off instead of piling on.

    Swap surface: the service exposes the shared actor-host attribute
    contract (``version``/``arch``/``params``/``_explore_kwargs``/
    ``_lock``/``_wire_decoder``) so :func:`apply_bundle_swap` /
    :func:`apply_wire_swap` gate installs exactly as on every other
    actor tier — one params read per batch under ``_lock`` makes a batch
    single-version by construction.
    """

    def __init__(
        self,
        bundle: ModelBundle,
        max_batch: int = 16,
        batch_timeout_ms: float = 5.0,
        buckets=None,
        queue_limit: int = 1024,
        retry_after_s: float = 0.05,
        stale_after_s: float = 5.0,
        max_sessions: int = 4096,
        session_ttl_s: float = 600.0,
        validate: bool = True,
        device=None,
    ):
        from relayrl_tpu_torch.models import build_policy, validate_policy

        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._lock = threading.Lock()
        self.arch = dict(bundle.arch)
        self.policy = build_policy(self.arch, device)
        self.device = self.policy.device
        self.params = self.policy.load_params(bundle.params)
        if validate:
            validate_policy(self.policy, self.params)
        self.version = bundle.version
        self._explore_kwargs = exploration_kwargs(self.arch)
        self._wire_decoder = None
        self.swaps = 0
        from relayrl_tpu_torch.runtime.policy_actor import (
            make_keyed_batched_step,
            make_keyed_batched_window_step,
            resolve_actor_context,
        )

        self._batched_fn = make_keyed_batched_step(self.policy)
        # Sequence policies (serving v2): the per-client rolling window
        # lives HERE, in the session table, keyed by the client-supplied
        # session id — the TorchBeast "server owns recurrent state"
        # shape. The dispatch is the keyed form of the
        # make_batched_window_step composition every local tier runs.
        self._window_fn = None
        self.ctx = 0
        if self.policy.step_window is not None:
            self.ctx = resolve_actor_context(self.arch)
            self._window_fn = make_keyed_batched_window_step(self.policy)
        from collections import OrderedDict

        self._sessions: "OrderedDict[str, _Session]" = OrderedDict()
        self.max_sessions = max(1, int(max_sessions))
        self.session_ttl_s = max(0.0, float(session_ttl_s))

        self.max_batch = int(max_batch)
        self.batch_timeout_s = max(0.0, float(batch_timeout_ms)) / 1000.0
        self.buckets = sorted(set(
            int(b) for b in (buckets or default_buckets(self.max_batch))))
        if self.buckets[-1] < self.max_batch:
            # The largest bucket must cover a size-closed full batch, or
            # pick_bucket would clamp DOWN and the pad computation go
            # negative — every full batch would then fail forever. (The
            # ConfigLoader applies the same clamp; direct constructions
            # get it here.)
            self.buckets.append(self.max_batch)
        self.queue_limit = max(1, int(queue_limit))
        self.retry_after_s = max(0.0, float(retry_after_s))
        # Ghost-work guard: a request older than this has been abandoned
        # by its client (whose per-attempt timeout elapsed and whose
        # retry is already queued behind it) — dispatching it anyway
        # would double-serve every retry round and amplify exactly the
        # backlog that made it stale. Such entries are answered with a
        # retryable nack at batch-gather time instead. 0 disables.
        self.stale_after_s = max(0.0, float(stale_after_s))

        self._queue: deque[InferRequest] = deque()
        self._cond = threading.Condition()
        self._worker: threading.Thread | None = None
        self._stop = threading.Event()
        self._zmq_plane = None
        self._zmq_addr = None

        from relayrl_tpu_torch import telemetry

        reg = telemetry.get_registry()
        self._m_requests = reg.counter(
            "relayrl_serving_requests_total",
            "observation requests accepted into the batching queue")
        self._m_rejected = reg.counter(
            "relayrl_serving_rejected_total",
            "requests nacked NACK_OVERLOADED at the queue limit")
        self._m_errors = reg.counter(
            "relayrl_serving_request_errors_total",
            "malformed/unservable requests answered with an error reply")
        self._m_batches = {
            reason: reg.counter(
                "relayrl_serving_batches_total",
                "closed inference batches by close trigger",
                {"reason": reason})
            for reason in (CLOSE_SIZE, CLOSE_DEADLINE)}
        self._m_stale = reg.counter(
            "relayrl_serving_stale_dropped_total",
            "queued requests nacked unserved because they outlived "
            "serving.stale_after_s (their client already timed out and "
            "retried — dispatching them would double-serve ghost work)")
        self._m_occupancy = reg.histogram(
            "relayrl_serving_batch_occupancy",
            "requests per closed batch (occupancy > 1 = batching works)",
            # torchlint: disable=MET03 - dimensionless request count, not a dimensioned unit
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
        self._m_dispatch_s = reg.histogram(
            "relayrl_serving_dispatch_seconds",
            "one batched policy dispatch (device compute + reply encode)")
        from relayrl_tpu_torch.telemetry.core import LATENCY_BUCKETS_WIDE

        self._m_request_s = reg.histogram(
            "relayrl_serving_request_seconds",
            "request enqueue to reply handoff (queue wait + batch close "
            "wait + dispatch share)",
            # Wide log-spaced grid: a 5 s top bucket would pin
            # overload-backlogged requests in +Inf.
            buckets=LATENCY_BUCKETS_WIDE)
        self._m_evictions = {
            reason: reg.counter(
                "relayrl_serving_session_evictions_total",
                "sessions dropped from the table by cause (lru = "
                "serving.max_sessions pressure, ttl = idle past "
                "serving.session_ttl_s)",
                {"reason": reason})
            for reason in ("lru", "ttl")}
        self._m_resyncs = reg.counter(
            "relayrl_serving_session_resyncs_total",
            "sessions rebuilt from a client-shipped window (after an "
            "eviction nack or a replica re-route)")
        self._m_session_nacked = reg.counter(
            "relayrl_serving_session_nacked_total",
            "requests answered NACK_SESSION_EVICTED (client resyncs by "
            "resending its episode window)")
        import weakref

        wref = weakref.ref(self)

        def _depth():
            svc = wref()
            return None if svc is None else len(svc._queue)

        reg.gauge_fn("relayrl_serving_queue_depth", _depth,
                     "observation requests awaiting a batch close")

        def _sessions():
            svc = wref()
            return None if svc is None else len(svc._sessions)

        reg.gauge_fn("relayrl_serving_sessions", _sessions,
                     "live per-session windows in the serving table")

    @classmethod
    def from_config(cls, bundle: ModelBundle, config,
                    validate: bool = True,
                    device=None) -> "InferenceService":
        p = config.get_serving_params()
        return cls(bundle, max_batch=p["max_batch"],
                   batch_timeout_ms=p["batch_timeout_ms"],
                   buckets=p["buckets"], queue_limit=p["queue_limit"],
                   retry_after_s=p["retry_after_s"],
                   stale_after_s=p["stale_after_s"],
                   max_sessions=p["max_sessions"],
                   session_ttl_s=p["session_ttl_s"], validate=validate,
                   device=device)

    # -- lifecycle --
    def bind_zmq(self, addr: str) -> None:
        """Bind (or re-bind on restart) the ROUTER serving plane at
        ``addr`` — the action channel for zmq fleets AND the native
        passthrough (the C++ core has no request/response action RPC)."""
        self._zmq_addr = addr

    def start(self) -> None:
        if self._worker is not None:
            return
        self._stop.clear()
        if self._zmq_addr is not None:
            from relayrl_tpu_torch.transport.serving import ZmqServingPlane

            self._zmq_plane = ZmqServingPlane(self._zmq_addr,
                                              self.handle_request)
            self._zmq_plane.start()
        self._worker = threading.Thread(
            target=self._serve_loop, name="inference-batcher", daemon=True)
        self._worker.start()

    def stop(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=10)
            self._worker = None
        # Parked requests answer with a retryable nack, not silence: a
        # restarting service must not wedge clients for a full timeout.
        # This must happen BEFORE the zmq plane closes — the nack rides
        # the plane's reply pipe, and a closed PUSH socket would drop it
        # silently (the plane's own stop() drains the pipe).
        with self._cond:
            pending, self._queue = list(self._queue), deque()
        for req in pending:
            self._safe_reply(req, pack_infer_nack(
                req.req_id, NACK_OVERLOADED, "inference service stopping",
                max(self.retry_after_s, 0.05)))
        if self._zmq_plane is not None:
            self._zmq_plane.stop()
            self._zmq_plane = None

    # -- model install --
    def maybe_swap(self, bundle: ModelBundle) -> bool:
        """Install a newer model (shared gate with every actor host):
        in-flight batches finish on the old version, the next batch reads
        the new one — single-version-per-batch either way."""
        from relayrl_tpu_torch.runtime.policy_actor import apply_bundle_swap

        return apply_bundle_swap(self, bundle)

    def swap_from_wire(self, version: int, blob: bytes):
        """Wire-v2-aware swap for standalone hosts subscribing over an
        agent transport (same decode path as every actor)."""
        from relayrl_tpu_torch.runtime.policy_actor import apply_wire_swap

        return apply_wire_swap(self, version, blob)

    def install_params(self, version: int, arch: dict, host_params) -> bool:
        """Colocated feed: the TrainingServer hands the freshly published
        host tree straight in (zero wire hops). The install owns its
        memory: :func:`apply_bundle_swap` builds a NEW params module on
        the serving device from the tree (the publisher's buffers keep
        moving) before it takes the lock, and a dispatch in flight keeps
        the module it read; nothing is ever copied into tensors a
        dispatch may be reading."""
        return self.maybe_swap(ModelBundle(version=int(version),
                                           arch=dict(arch),
                                           params=host_params))

    # -- request intake (transport threads) --
    def handle_request(self, payload: bytes, reply) -> InferRequest | None:
        """Transport callback: decode + enqueue (never dispatches here).
        Malformed frames answer code 0; a full queue answers the typed
        overload nack with retry-after. Returns the queued request (None
        when it was answered instead of queued) so blocking adapters can
        retract it on their own timeout. Runs on transport threads."""
        try:
            rows = unpack_infer_any(payload)
        except Exception:
            self._m_errors.inc()
            reply(pack_infer_nack(-1, 0, "malformed inference request"))
            return None
        wave = len(rows) > 1
        queued = None
        for req in rows:
            request = InferRequest(req["id"], req["req"], req["key"],
                                   req["obs"], req["mask"], reply,
                                   sid=req["sid"], rst=req["rst"],
                                   stp=req["stp"], win=req["win"],
                                   wave=wave)
            if self.submit(request):
                queued = request
        return queued

    def handle_request_blocking(self, payload: bytes) -> bytes:
        """RPC-thread adapter (grpc ``GetActions``): enqueue, then block
        this thread until its batch executes. The wait bound covers the
        worst batch close + dispatch; beyond it the client gets a
        retryable nack instead of a hung RPC — and the orphaned request
        is RETRACTED from the queue (if still there): under sustained
        overload a timed-out RPC must not leave ghost work behind that
        amplifies the very backlog that timed it out."""
        box: dict = {}
        done = threading.Event()

        def reply(b: bytes) -> None:
            box["reply"] = b
            done.set()

        request = self.handle_request(payload, reply)
        # Park bound: batch close + a stale-sweep interval, NOT a flat
        # 30 s — the caller's RPC deadline is ~request_timeout_s, and a
        # thread still parked long after it has been abandoned occupies
        # a slot in the gRPC pool the trajectory/long-poll planes share
        # (64 retrying clients would exhaust max_workers=128 and stall
        # ingest fleet-wide).
        done.wait(timeout=self.batch_timeout_s
                  + (self.stale_after_s or 5.0) + 2.0)
        if "reply" not in box and request is not None:
            with self._cond:
                try:
                    self._queue.remove(request)
                except ValueError:
                    pass  # already dispatched: its reply lands in the
                    #       abandoned box, a harmless one-off
        return box.get("reply") or pack_infer_nack(
            -1, NACK_OVERLOADED, "inference batch timed out",
            max(self.retry_after_s, 0.05))

    def submit(self, req: InferRequest) -> bool:
        """Queue one decoded request (True), or answer the overload nack
        when the queue is at ``serving.queue_limit`` (False — bounded
        queue = bounded worst-case latency; the client's retry-after
        honor is the backpressure loop)."""
        from relayrl_tpu_torch.telemetry import trace as trace_mod

        tracer = trace_mod.get_tracer()
        if tracer.enabled:
            # Both trace fields are final BEFORE the request becomes
            # visible to the batch worker, which reads them at gather.
            req.trace = tracer.sample_id("serve")
            if req.trace is not None:
                req.t_enqueue_ns = time.monotonic_ns()
        with self._cond:
            if len(self._queue) >= self.queue_limit or self._stop.is_set():
                overloaded = True
            else:
                overloaded = False
                self._queue.append(req)
                self._cond.notify()
        if overloaded:
            self._m_rejected.inc()
            self._safe_reply(req, pack_infer_nack(
                req.req_id, NACK_OVERLOADED, "inference queue full",
                self.retry_after_s))
            return False
        self._m_requests.inc()
        return True

    # -- the batching loop (worker thread) --
    def _serve_loop(self) -> None:
        while not self._stop.is_set():
            batch, reason = self._gather_batch()
            if batch:
                self._execute(batch, reason)

    def _gather_batch(self) -> tuple[list[InferRequest], str]:
        """Block for the first request, then accumulate until
        ``max_batch`` (size close) or ``batch_timeout_ms`` past the first
        request's enqueue (deadline close). The deadline anchors at
        ENQUEUE, not batch open: time a request spent queued behind the
        previous dispatch counts against its latency budget, so a loaded
        service degrades to immediate closes instead of stacking
        timeouts."""
        stale: list[InferRequest] = []

        def pop_fresh():
            # Ghost-work guard: entries older than stale_after_s were
            # abandoned by their (timed-out, already-retrying) client —
            # nack them unserved instead of double-serving every retry
            # round under backlog. Collected here, answered outside the
            # lock.
            while self._queue:
                req = self._queue.popleft()
                if (self.stale_after_s
                        and time.monotonic() - req.t_enqueue
                        > self.stale_after_s):
                    stale.append(req)
                    continue
                return req
            return None

        batch: list[InferRequest] = []
        with self._cond:
            first = pop_fresh()
            # Exit the wait as soon as there is ANYTHING to act on —
            # a fresh request to batch, or stale ones to nack (their
            # clients must not wait for unrelated traffic to arrive
            # before learning their request was shed).
            while first is None and not stale:
                if self._stop.is_set():
                    break
                self._cond.wait(0.1)
                first = pop_fresh()
            if first is not None:
                batch = [first]
                deadline = first.t_enqueue + self.batch_timeout_s
                while len(batch) < self.max_batch:
                    if self._queue:
                        got = pop_fresh()
                        if got is not None:
                            batch.append(got)
                        continue
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or self._stop.is_set():
                        break
                    self._cond.wait(remaining)
        for req in stale:
            self._m_stale.inc()
            self._safe_reply(req, pack_infer_nack(
                req.req_id, NACK_OVERLOADED, "request went stale in queue",
                self.retry_after_s))
        reason = CLOSE_SIZE if len(batch) >= self.max_batch \
            else CLOSE_DEADLINE
        return batch, reason

    def _execute(self, batch: list[InferRequest], reason: str) -> None:
        t0 = time.monotonic()
        # Close accounting rides AHEAD of the dispatch: a reply observer
        # (test, bench row) reading the counters right after its reply
        # arrives must already see this batch counted — the timing
        # histograms below stay post-dispatch because they measure it.
        self._m_batches[reason].inc()
        self._m_occupancy.observe(len(batch))
        # ONE params/version/explore read under the swap gate for the
        # whole batch: no request in it can ever be served by a different
        # model version than its batchmates (the invariant the vector
        # host enforces per dispatch, test-locked against a racing
        # swapper).
        with self._lock:
            params = self.params
            version = self.version
            explore = self._explore_kwargs
        if self._window_fn is not None:
            # Sequence policy: resolve each request against the session
            # table first (push/idempotent-retry/resync/evicted) — only
            # requests that resolved into a window row dispatch.
            batch = self._resolve_sessions(batch)
        # Mixed fleets may interleave request shapes (masked vs maskless,
        # pixel vs vector observations): group by signature, one bucketed
        # dispatch per group. Homogeneous fleets — the common case — see
        # exactly one group.
        groups: dict[tuple, list[InferRequest]] = {}
        for req in batch:
            sig = (req.obs.shape, str(req.obs.dtype), req.mask is not None,
                   str(req.key.dtype), req.key.shape)
            groups.setdefault(sig, []).append(req)
        for group in groups.values():
            try:
                if self._window_fn is not None:
                    self._dispatch_window_group(group, params, version)
                else:
                    self._dispatch_group(group, params, version, explore)
            except Exception as e:
                # One unservable group (bad shapes, dtype surprises) must
                # not take down the worker or its batchmates: every
                # member gets a retryable error reply.
                self._m_errors.inc(len(group))
                for req in group:
                    self._safe_reply(req, pack_infer_nack(
                        req.req_id, 0, f"dispatch failed: {e!r}"))
        now = time.monotonic()
        self._m_dispatch_s.observe(now - t0)
        for req in batch:
            self._m_request_s.observe(now - req.t_enqueue)
        traced = [req for req in batch if req.trace is not None]
        if traced:
            # Serve-plane hop spans for sampled requests: queue (enqueue
            # to batch gather) and dispatch (gather to reply handoff).
            from relayrl_tpu_torch.telemetry import trace as trace_mod

            tracer = trace_mod.get_tracer()
            now_ns = time.monotonic_ns()
            t0_ns = now_ns - int((now - t0) * 1e9)
            for req in traced:
                tracer.span("serve", req.trace, "queue",
                            req.t_enqueue_ns, t0_ns, agent=req.agent_id)
                tracer.span("serve", req.trace, "dispatch", t0_ns,
                            now_ns, occupancy=len(batch))

    # -- session table (serving v2; worker thread only) --
    #
    # The table has no lock of its own because the batch worker is its
    # ONLY reader and writer — transport threads just park decoded
    # requests in the queue. The gauge_fn len() read races harmlessly.
    def _resolve_sessions(self,
                          batch: list[InferRequest]) -> list[InferRequest]:
        """Turn session requests into dispatchable window rows. Answers
        everything unservable in place: no session id (error), unknown
        mid-episode session (NACK_SESSION_EVICTED — the client resyncs
        by resending its episode window), out-of-step cursor (same
        nack). A retry of an already-applied push (same ``stp``)
        recomputes from the current window WITHOUT re-pushing — with the
        client's unchanged key the recompute is bit-identical, so
        at-least-once delivery never corrupts state."""
        from relayrl_tpu_torch.transport.base import NACK_SESSION_EVICTED

        now = time.monotonic()
        self._expire_sessions(now)
        served: list[InferRequest] = []
        for req in batch:
            try:
                if req.sid is None:
                    self._m_errors.inc()
                    self._safe_reply(req, pack_infer_nack(
                        req.req_id, 0,
                        "sequence policy serving requires a session id "
                        "(serving-v2 client; sessions are bounded by "
                        "serving.max_sessions)"))
                    continue
                sess = self._sessions.get(req.sid)
                if sess is None:
                    if not req.rst and req.win is None:
                        # Mid-episode request for a window this service
                        # does not hold (evicted, expired, or a fresh
                        # replica after re-route): typed resync nack.
                        self._m_session_nacked.inc()
                        self._safe_reply(req, pack_infer_nack(
                            req.req_id, NACK_SESSION_EVICTED,
                            "session not held (evicted or new replica) "
                            "— resend the request with the episode "
                            "window attached", self.retry_after_s))
                        continue
                    sess = _Session(self.ctx, int(self.arch["obs_dim"]),
                                    now)
                    sess.episode_step = req.stp - 1
                    self._sessions[req.sid] = sess
                    self._evict_lru()
                if req.win is not None:
                    # Client-shipped history is ground truth: rebuild
                    # wholesale (heals evictions, re-routes, and any
                    # split-brain a retry storm could leave behind).
                    self._restore_window(sess, req.win)
                    sess.episode_step = req.stp - 1
                    self._m_resyncs.inc()
                self._sessions.move_to_end(req.sid)
                sess.last_used = now
                if req.stp == sess.episode_step:
                    pass  # applied-push retry: recompute, don't re-push
                elif req.stp == sess.episode_step + 1:
                    if req.rst:
                        # Episode boundary: the new episode must not
                        # attend the previous one's observations.
                        sess.window[:] = 0.0
                        sess.length = 0
                    self._push_session(sess, req.obs)
                    sess.episode_step = req.stp
                else:
                    self._m_session_nacked.inc()
                    self._safe_reply(req, pack_infer_nack(
                        req.req_id, NACK_SESSION_EVICTED,
                        f"session cursor out of step (held "
                        f"{sess.episode_step}, got {req.stp}) — resend "
                        f"the request with the episode window attached",
                        self.retry_after_s))
                    continue
                req.window_row = sess.window
                req.window_t = sess.length
                served.append(req)
            except Exception as e:
                # Malformed session payload (wrong obs_dim, bad window
                # shape): a per-request error, never a dead worker.
                self._m_errors.inc()
                self._safe_reply(req, pack_infer_nack(
                    req.req_id, 0, f"session resolve failed: {e!r}"))
        return served

    def _restore_window(self, sess: _Session, win: np.ndarray) -> None:
        rows = np.asarray(win, np.float32).reshape(
            (-1, sess.window.shape[1]))[-self.ctx:]
        sess.window[:] = 0.0
        sess.window[:rows.shape[0]] = rows
        sess.length = rows.shape[0]

    @staticmethod
    def _push_session(sess: _Session, obs: np.ndarray) -> None:
        # The parity contract requires the served window to roll the way
        # a local one does — so advance through the shared rule.
        sess.length, _ = push_window(sess.window, sess.length, obs)

    def _evict_lru(self) -> None:
        from relayrl_tpu_torch import telemetry

        while len(self._sessions) > self.max_sessions:
            sid, _ = self._sessions.popitem(last=False)
            self._m_evictions["lru"].inc()
            telemetry.emit("serving_session_evicted", session=sid,
                           reason="lru")

    def _expire_sessions(self, now: float) -> None:
        if not self.session_ttl_s:
            return
        from relayrl_tpu_torch import telemetry

        horizon = now - self.session_ttl_s
        while self._sessions:
            sid, sess = next(iter(self._sessions.items()))
            if sess.last_used >= horizon:
                break  # LRU order: everything behind is fresher
            self._sessions.popitem(last=False)
            self._m_evictions["ttl"].inc()
            telemetry.emit("serving_session_evicted", session=sid,
                           reason="ttl")

    def _padded(self, n: int):
        """The function padding a ``[n, ...]`` stack to the bucket a group
        of ``n`` dispatches at, by repeating the last row. Rows draw from
        their own keys and attend only their own window, so pad content
        cannot perturb real rows (the padding-invariance test locks it);
        repeating a REAL row keeps dtypes and shapes trivially right."""
        bucket = pick_bucket(n, self.buckets)

        def pad(stack: np.ndarray) -> np.ndarray:
            if bucket == n:
                return stack
            return np.concatenate(
                [stack, np.repeat(stack[-1:], bucket - n, axis=0)])
        return pad

    def _dispatch_window_group(self, group: list[InferRequest], params,
                               version: int) -> None:
        padded = self._padded(len(group))
        keys = padded(np.stack([r.key for r in group]))
        # np.stack COPIES the session windows at dispatch time, so the
        # device sees a stable snapshot even though the table's arrays
        # keep rolling under later batches.
        windows = padded(np.stack([r.window_row for r in group]))
        ts = padded(np.asarray([r.window_t for r in group], np.int32))
        masks = None
        if group[0].mask is not None:
            masks = padded(np.stack([r.mask for r in group]))
        acts, aux, next_keys = self._window_fn(params, keys, windows, ts,
                                               masks)
        self._send_group_replies(group, version, acts, next_keys, aux,
                                 ctx=self.ctx)

    def _dispatch_group(self, group: list[InferRequest], params,
                        version: int, explore: dict) -> None:
        padded = self._padded(len(group))
        keys = padded(np.stack([r.key for r in group]))
        obs = padded(np.stack([r.obs for r in group]))
        masks = None
        if group[0].mask is not None:
            masks = padded(np.stack([r.mask for r in group]))
        acts, aux, next_keys = self._batched_fn(params, keys, obs, masks,
                                                explore)
        self._send_group_replies(group, version, acts, next_keys, aux)

    def _send_group_replies(self, group: list[InferRequest], version: int,
                            acts_np: np.ndarray, keys_np: np.ndarray,
                            aux_np: dict, ctx: int | None = None) -> None:
        """Reply fan-out with wave coalescing: batchmates that arrived on
        the same wave frame (one shared reply pipe) leave as ONE stacked
        frame per dispatch batch; everything else — singles, nacks, lone
        wave survivors — rides the per-request wire. The per-reply pack
        cost is the serving plane's largest per-step Python cost
        (~50us), so coalescing here is half the wave wire's win."""
        singles: list[int] = []
        waves: dict[int, list[int]] = {}
        order: list[int] = []
        for i, req in enumerate(group):
            if req.wave:
                k = id(req.reply)
                if k not in waves:
                    waves[k] = []
                    order.append(k)
                waves[k].append(i)
            else:
                singles.append(i)
        for k in order:
            idxs = waves[k]
            if len(idxs) == 1:
                singles.append(idxs[0])
                continue
            reqs = [group[i] for i in idxs]
            sel = np.asarray(idxs)
            payload = pack_reply_wave(
                [r.req_id for r in reqs], version, acts_np[sel],
                keys_np[sel], {a: v[sel] for a, v in aux_np.items()},
                ctx=ctx)
            self._safe_reply(reqs[0], payload)
        for i in singles:
            req = group[i]
            # np.asarray on the indexed rows: a stacked [N] column
            # indexes to a numpy scalar, and the wire must carry the 0-d
            # ndarray's exact dtype (the vector-host float64 lesson).
            self._safe_reply(req, pack_action_reply(
                req.req_id, version, np.asarray(acts_np[i]), keys_np[i],
                {a: np.asarray(v[i]) for a, v in aux_np.items()},
                ctx=ctx))

    @staticmethod
    def _safe_reply(req: InferRequest, payload: bytes) -> None:
        """Reply-delivery isolation: one dead client connection must not
        take down the batch that served its neighbors."""
        try:
            req.reply(payload)
        except Exception as e:
            print(f"[InferenceService] reply delivery failed: {e!r}",
                  flush=True)

    def accounting(self) -> dict:
        """Bench/drill evidence block (mirrors the registry counters)."""
        return {
            "queue_depth": len(self._queue),
            "max_batch": self.max_batch,
            "batch_timeout_ms": self.batch_timeout_s * 1000.0,
            "buckets": list(self.buckets),
            "sessions": len(self._sessions),
            "max_sessions": self.max_sessions,
            "ctx": self.ctx,
        }


class RemoteActorClient:
    """Thin-client actor (``actor.host_mode: "remote"``): holds NO
    params, NO model subscription, NO swap gate — every action is a
    request/response round-trip to an :class:`InferenceService`. The
    trajectory plane (Trajectory assembly, spool sequence tags, transport
    envelopes) is the standard actor plane, byte-identical on the wire.

    The client carries its key (``uint32[2]``, ``[0, seed]`` as
    ``jax.random.PRNGKey(seed)`` makes it) and round-trips it through the
    service, which draws the action and the successor key from it alone,
    so the served action stream equals the keyed batched step driven
    locally one request at a time from the same key — the parity
    contract ``tests/test_torch_serving.py`` locks.

    Overload nacks honor the server's ``retry_after_s`` without charging
    the circuit breaker (the server is alive and answered — the spool's
    nack lesson); transport failures back off under the shared
    ``transport.retry`` policy behind a breaker, so a killed service
    never wedges the env loop in a hot retry spin.
    """

    def __init__(
        self,
        config_path: str | None = None,
        server_type: str = "zmq",
        seed: int | None = None,
        identity: str | None = None,
        start: bool = True,
        handshake_timeout_s: float = 60.0,
        **addr_overrides,
    ):
        import os

        from relayrl_tpu_torch.config import ConfigLoader

        self.config = ConfigLoader(None, config_path)
        from relayrl_tpu_torch import faults, telemetry

        telemetry.configure_from_config(self.config)
        faults.maybe_install_from_env()
        self._fault_infer = faults.site("agent.infer")
        self.server_type = server_type
        self._addr_overrides = addr_overrides
        self._identity = identity
        self._handshake_timeout_s = handshake_timeout_s
        self._seed = os.getpid() if seed is None else seed
        serving = self.config.get_serving_params()
        self._request_timeout_s = serving["request_timeout_s"]
        self._infer_deadline_s = serving["infer_deadline_s"]
        self._lock = threading.Lock()
        self._req_counter = 0
        self.version = -1  # latest service version that answered us
        self.steps_served = 0
        # Serving-v2 session state: every request carries a session id
        # (the transport identity) + a monotonic push cursor, so sequence
        # policies serve from a SERVER-side rolling window. The client
        # keeps a small mirror of the current episode's observations —
        # the resync source after a NACK_SESSION_EVICTED or a replica
        # re-route — bounded to the service's window length once a reply
        # names it. Stateless policies answer without a ``ctx`` field and
        # the mirror shuts off.
        self._session_id = None
        self._session_step = 0
        self._episode_start = True
        self._mirror: list | None = []
        # Horizontal serving: session-affine home replica out of
        # serving.replicas, rotated after repeated transport failures
        # (the new replica answers NACK_SESSION_EVICTED and the resync
        # machinery rebuilds the session there).
        self._replica_addrs: list[str] | None = None
        self._replica_idx = 0
        self._replica_fail_streak = 0
        self._serving_overrides: dict = {}
        self.transport = None
        self.spool = None
        self._fleet_emitter = None
        self._serving = None
        self._breaker = None
        self._retry = None
        self.trajectory = Trajectory(
            max_length=self.config.get_max_traj_length(),
            on_send=self._send_traj)
        self._rng = prng_key(self._seed)
        reg = telemetry.get_registry()
        self._m_steps = reg.counter(
            "relayrl_actor_env_steps_total",
            "policy steps served (one per env step per lane)")
        from relayrl_tpu_torch.telemetry.core import LATENCY_BUCKETS_WIDE

        self._m_request_s = reg.histogram(
            "relayrl_serving_client_request_seconds",
            "one action round-trip on the client (send to decoded reply, "
            "retries included)",
            # Wide grid: retries through an open breaker legitimately
            # stack past a 5 s top bucket.
            buckets=LATENCY_BUCKETS_WIDE)
        self._m_retries = reg.counter(
            "relayrl_serving_client_retries_total",
            "inference request attempts beyond the first")
        self._m_nacked = reg.counter(
            "relayrl_serving_client_nacked_total",
            "overload nacks honored (slept retry_after_s, no breaker "
            "charge)")
        self._m_resyncs = reg.counter(
            "relayrl_serving_client_resyncs_total",
            "session resyncs performed (episode window resent after a "
            "NACK_SESSION_EVICTED or replica re-route)")
        self._m_reroutes = reg.counter(
            "relayrl_serving_client_reroutes_total",
            "replica re-routes after persistent transport failures on "
            "the session-affine home replica")
        self.active = False
        if start:
            self.enable_agent()

    # -- lifecycle (Agent-compatible surface) --
    def enable_agent(self) -> None:
        if self.active:
            return
        from relayrl_tpu_torch.transport import make_agent_transport
        from relayrl_tpu_torch.transport.retry import (
            RetryPolicy,
            breaker_from_config,
        )
        from relayrl_tpu_torch.transport.serving import make_serving_client

        overrides = dict(self._addr_overrides)
        overrides.setdefault("negotiate_window_s",
                             min(self._handshake_timeout_s * 0.5, 30.0))
        if self._identity is not None:
            overrides.setdefault("identity", self._identity)
        serving_overrides = {
            k: overrides.pop(k)
            for k in ("serving_addr", "serving_plane", "serving_addrs",
                      "stream")
            if k in overrides}
        self.transport = make_agent_transport(
            self.server_type, self.config, **overrides)
        self._session_id = self.transport.identity
        # Horizontal serving: an explicit serving_addrs override or the
        # serving.replicas config names N replica endpoints; this
        # session's home replica is hash(session_id) % N (stable crc32 —
        # affinity must agree across client restarts). zmq-plane only:
        # the grpc in-band plane rides the agent channel.
        replicas = serving_overrides.pop("serving_addrs", None) \
            or self.config.get_serving_params()["replicas"]
        plane = serving_overrides.get("serving_plane") or (
            "grpc" if self.server_type == "grpc" else "zmq")
        if replicas and plane != "grpc" \
                and "serving_addr" not in serving_overrides:
            import zlib

            self._replica_addrs = [str(a) for a in replicas]
            self._replica_idx = (zlib.crc32(self._session_id.encode())
                                 % len(self._replica_addrs))
            serving_overrides["serving_addr"] = \
                self._replica_addrs[self._replica_idx]
        self._serving_overrides = dict(serving_overrides)
        # No fetch_model: the whole point is that this actor never holds
        # a model. Registration still announces the logical agent.
        try:
            self.transport.register(self.transport.identity, timeout_s=10.0)
        except Exception as e:
            print(f"[RemoteActorClient] registration failed (continuing "
                  f"unregistered): {e!r}", flush=True)
        self._bind_spool()
        self.transport.on_reconnect = self._handle_reconnect
        retry_cfg = self.config.get_transport_params()["retry"]
        self._retry = RetryPolicy.from_dict(retry_cfg)
        if self._breaker is None:
            self._breaker = breaker_from_config(
                f"infer:{self._identity or 'remote'}", retry_cfg)
        self._serving = make_serving_client(
            self.server_type, self.config, transport=self.transport,
            **serving_overrides)
        from relayrl_tpu_torch.runtime.agent import _start_fleet_emitter

        self._fleet_emitter = _start_fleet_emitter(self, "client")
        self.active = True
        from relayrl_tpu_torch import telemetry

        telemetry.emit("agent_register", agent_id=self.transport.identity,
                       side="agent", mode="remote")

    def disable_agent(self) -> None:
        if not self.active:
            return
        from relayrl_tpu_torch.runtime.agent import _close_fleet_emitter

        drain_s = _close_fleet_emitter(self)
        if self.spool is not None:
            self.spool.send_fn = None
        if self._serving is not None:
            self._serving.close()
            self._serving = None
        self.transport.close(drain_s=drain_s)
        self.transport = None
        self.active = False

    def _bind_spool(self) -> None:
        from relayrl_tpu_torch.runtime.agent import _bind_spool_impl

        _bind_spool_impl(self, self._identity or "remote")

    def _handle_reconnect(self) -> None:
        from relayrl_tpu_torch.runtime.agent import _handle_reconnect_impl

        _handle_reconnect_impl(self, [self.transport.identity])

    def _send_traj(self, payload: bytes) -> None:
        # Trajectory tracing as Agent._send_traj: the thin client's
        # episodes draw trace contexts too (the env hop is the
        # round-trip-served production window).
        from relayrl_tpu_torch.runtime.agent import _trace_emit, _traced_send

        traj = self.trajectory
        ctx = _trace_emit(self.transport.identity, traj.born_ns,
                          traj.encode_t0_ns, traj.encode_t1_ns,
                          self.version)
        _traced_send(self, payload, self.transport.identity, ctx)

    # -- action API (PolicyActor-shaped) --
    def request_for_action(self, obs, mask=None,
                           reward: float = 0.0) -> ActionRecord:
        """One served action: ship the observation + current PRNG key,
        append the returned action to the trajectory. Reward credit
        semantics identical to ``PolicyActor.request_for_action`` (the
        reward lands on the PREVIOUS record)."""
        self._require_active()
        from relayrl_tpu_torch.runtime.policy_actor import normalize_obs

        # Byte frames stay bytes on the wire, everything else float32 —
        # the shared rule every tier uses (the parity contract rides on
        # it staying ONE body).
        obs = normalize_obs(obs)
        mask_arr = None if mask is None else np.asarray(mask, np.float32)
        with self._lock:
            if reward and self.trajectory.get_actions():
                self.trajectory.get_actions()[-1].update_reward(
                    float(reward))
            # torchlint: disable=LOCK02 - per-client lock; the env loop is serial, blocking here IS the backpressure
            act, aux = self._infer(obs, mask_arr)
            record = ActionRecord(
                obs=obs, act=act, mask=mask_arr,
                rew=0.0,  # filled by the NEXT request / terminal marker
                data=aux, done=False)
            self.trajectory.add_action(record, send_if_done=True)
            self.steps_served += 1
        self._m_steps.inc()
        return record

    def flag_last_action(self, reward: float = 0.0, truncated: bool = False,
                         final_obs=None, terminated: bool | None = None,
                         final_mask=None) -> None:
        """Terminal marker — same semantics as PolicyActor's (terminated
        beats truncated, the bootstrap final_obs rides the marker). The
        next request carries the episode-reset flag so the SERVER-side
        session window zeroes at the boundary, exactly where a local
        windowed actor zeroes its own."""
        self._require_active()
        if terminated:
            truncated = False
        with self._lock:
            self._episode_start = True
            if self._mirror is not None:
                self._mirror = []
            record = ActionRecord(
                obs=(None if final_obs is None
                     else np.asarray(final_obs, np.float32)),
                mask=(None if final_mask is None
                      else np.asarray(final_mask, np.float32)),
                rew=float(reward), done=True, truncated=bool(truncated))
            self.trajectory.add_action(record, send_if_done=True)

    def record_action(self, action: ActionRecord) -> None:
        self._require_active()
        with self._lock:
            self.trajectory.add_action(action, send_if_done=True)

    def _infer(self, obs: np.ndarray, mask) -> tuple[np.ndarray, dict]:
        """One request/response round-trip with overload + failure
        handling (lock held — the env loop is serial per client):

        * overload nack → honor ``retry_after_s``, no breaker charge;
        * session-evicted nack → resend with the episode window attached
          (resync, not failure — no breaker charge, no backoff);
        * timeout / connection error → breaker charge + jittered backoff
          under ``transport.retry`` (a dead service opens the breaker and
          the loop waits out half-open probes instead of hot-spinning);
          persistent failures on a replica fleet rotate to the next
          replica (its eviction nack then triggers the resync above);
        * total budget ``serving.infer_deadline_s`` → RuntimeError (the
          env loop's caller decides; nothing is appended mid-failure).
        """
        self._req_counter += 1
        req_id = self._req_counter
        stp = self._session_step + 1
        rst = self._episode_start

        def build(with_win: bool) -> bytes:
            win = None
            if with_win and self._mirror:
                win = np.stack(self._mirror)
            return pack_infer_request(
                self.transport.identity, req_id, self._rng, obs, mask,
                session=self._session_id, reset=rst, window=win, step=stp)

        clean = build(False)
        first_attempt = clean
        dropped_first = False
        if self._fault_infer is not None:
            # chaos plane (agent.infer): the injection applies to the
            # FIRST attempt only — drop surfaces as a timeout → retry,
            # corrupt dies in the service's decode guard → retry, delay
            # sleeps here. Retries always carry the clean payload (one
            # fault per op, the plan's per-op contract — a corrupted
            # attempt retried corrupted forever would turn a 20%-corrupt
            # drill into guaranteed deadline exhaustion).
            parts = self._fault_infer.inject(clean)
            if not parts:
                dropped_first = True
            else:
                delay_s, first_attempt = parts[-1]
                if delay_s > 0:
                    time.sleep(delay_s)
        deadline = time.monotonic() + self._infer_deadline_s
        attempt = 0
        t0 = time.monotonic()
        last_error = ""
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise RuntimeError(
                    f"inference request exhausted its "
                    f"{self._infer_deadline_s:.0f}s budget "
                    f"(service down? breaker={self._breaker.state}"
                    f"{f'; last error: {last_error}' if last_error else ''})")
            if dropped_first:
                # fault-dropped first attempt: exactly a timeout's shape
                dropped_first = False
                self._note_failure(attempt, remaining)
                attempt += 1
                continue
            if not self._breaker.allow():
                time.sleep(min(0.2, remaining))
                continue
            try:
                reply = self._serving.request(
                    first_attempt if attempt == 0 else clean, req_id,
                    min(self._request_timeout_s, remaining))
            except (TimeoutError, ConnectionError, OSError):
                self._breaker.record_failure()
                self._replica_fail_streak += 1
                if self._replica_fail_streak >= 2 \
                        and self._rotate_replica():
                    # Replica death: session-affine re-route. The next
                    # replica will not hold this session and nacks
                    # SESSION_EVICTED — the resync branch below rebuilds
                    # it from the client's episode mirror.
                    self._replica_fail_streak = 0
                self._note_failure(attempt, deadline - time.monotonic())
                attempt += 1
                continue
            self._breaker.record_success()
            self._replica_fail_streak = 0
            code = reply["code"]
            if code == NACK_OVERLOADED:
                # The service is ALIVE and shed us: honor the hint, keep
                # the breaker closed (the IngestNack lesson).
                self._m_nacked.inc()
                time.sleep(min(max(reply["retry_after_s"], 0.001),
                               max(0.0, deadline - time.monotonic())))
                continue
            from relayrl_tpu_torch.transport.base import NACK_SESSION_EVICTED

            if code == NACK_SESSION_EVICTED:
                # Resync, not failure: resend the SAME request with the
                # episode window attached (the service rebuilds the
                # session wholesale from it). No breaker charge, no
                # backoff — the service is alive and asked for exactly
                # this.
                self._m_resyncs.inc()
                clean = first_attempt = build(True)
                attempt += 1
                continue
            if code == NACK_UNAVAILABLE:
                # PERMANENT: the endpoint answered but no inference
                # service is installed (serving.enabled false) — a
                # misconfiguration, not an outage; retrying would only
                # bury the pointed error under a deadline exhaustion.
                raise RuntimeError(
                    f"inference unavailable: {reply['error']}")
            if code != NACK_OK or "act" not in reply:
                # code-0 error (malformed/failed dispatch): retryable —
                # the chaos corrupt drill lands here.
                last_error = reply.get("error") or last_error
                self._note_failure(attempt, deadline - time.monotonic())
                attempt += 1
                continue
            self._rng = np.frombuffer(
                reply["key"], dtype=self._rng.dtype).copy()
            self.version = reply["ver"]
            self._session_step = stp
            self._episode_start = False
            ctx = reply.get("ctx")
            if ctx is None:
                # Stateless policy: the service keeps no window for us,
                # so there is nothing a resync could ever need.
                self._mirror = None
            elif self._mirror is not None:
                # Mirror AFTER success — during eviction-resync retries
                # the mirror must still exclude the current observation
                # (it rides the request itself). Bounded to the service
                # window: older rows can never matter to a resync.
                self._mirror.append(obs)
                if len(self._mirror) > ctx:
                    del self._mirror[:len(self._mirror) - ctx]
            self._m_request_s.observe(time.monotonic() - t0)
            return reply["act"], reply["aux"]

    def _rotate_replica(self) -> bool:
        """Re-route this session to the next replica (replica-fleet
        clients only). Returns True when the serving channel actually
        moved."""
        if not self._replica_addrs or len(self._replica_addrs) < 2:
            return False
        from relayrl_tpu_torch.transport.serving import make_serving_client

        self._replica_idx = (self._replica_idx + 1) \
            % len(self._replica_addrs)
        addr = self._replica_addrs[self._replica_idx]
        overrides = dict(self._serving_overrides)
        overrides["serving_addr"] = addr
        old, self._serving = self._serving, make_serving_client(
            self.server_type, self.config, transport=self.transport,
            **overrides)
        if old is not None:
            try:
                old.close()
            except Exception:
                pass
        self._m_reroutes.inc()
        from relayrl_tpu_torch import telemetry

        telemetry.emit("serving_replica_reroute",
                       agent_id=self._session_id, addr=addr)
        return True

    def _note_failure(self, attempt: int, remaining: float) -> None:
        self._m_retries.inc()
        if remaining > 0:
            time.sleep(min(self._retry.delay(attempt), remaining))

    @property
    def model_version(self) -> int:
        """Latest service-side params version that served this client an
        action (-1 before the first reply) — the thin client's analogue
        of an actor's installed version."""
        return self.version

    def _require_active(self) -> None:
        if not self.active or self._serving is None:
            raise RuntimeError(
                "remote actor client is not active (call enable_agent())")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.disable_agent()


class MultiplexedRemoteClient:
    """Thin-client host multiplexing N env lanes over the streaming
    serving channel — serving v2's answer to the lock-step plateau: one
    process keeps up to ``serving.stream_window`` requests in flight per
    replica connection (out-of-order replies legal, req-id matched), so
    the service sees dense batches from a single client instead of one
    request per Python round-trip.

    Each lane is an independent logical actor: its own session id
    (server-side rolling window for sequence policies), key
    (``prng_key(seed + lane)`` — lane i's action equals the keyed step's
    on its key and window at the bucket its batch dispatched),
    trajectory, and episode mirror. Lanes are session-affine
    across ``serving.replicas`` by ``crc32(session_id) % N``; a replica
    death re-routes its lanes and the eviction-nack resync rebuilds
    their windows on the new home.
    """

    def __init__(
        self,
        config_path: str | None = None,
        server_type: str = "zmq",
        lanes: int = 1,
        seed: int | None = None,
        identity: str | None = None,
        start: bool = True,
        handshake_timeout_s: float = 60.0,
        **addr_overrides,
    ):
        import os

        from relayrl_tpu_torch.config import ConfigLoader

        self.config = ConfigLoader(None, config_path)
        from relayrl_tpu_torch import telemetry

        telemetry.configure_from_config(self.config)
        self.server_type = server_type
        self.lanes = max(1, int(lanes))
        self._addr_overrides = addr_overrides
        self._identity = identity
        self._handshake_timeout_s = handshake_timeout_s
        self._seed = os.getpid() if seed is None else seed
        serving = self.config.get_serving_params()
        self._request_timeout_s = serving["request_timeout_s"]
        self._infer_deadline_s = serving["infer_deadline_s"]
        self._stream_window = serving["stream_window"]
        self._retry_after_default = serving["retry_after_s"]
        self._lock = threading.Lock()
        self._req_counter = 0
        self.version = -1
        self.transport = None
        self.spool = None
        self._fleet_emitter = None
        self._clients: list = []       # one streaming client per replica
        self._lane_client: list[int] = []  # lane -> client index
        self._retry = None
        self._keys = [prng_key(self._seed + i) for i in range(self.lanes)]
        self._session_steps = [0] * self.lanes
        self._episode_starts = [True] * self.lanes
        self._mirrors: list = [[] for _ in range(self.lanes)]
        self._sids: list[str] = []
        self.trajectories: list[Trajectory] = []
        reg = telemetry.get_registry()
        self._m_steps = reg.counter(
            "relayrl_actor_env_steps_total",
            "policy steps served (one per env step per lane)")
        self._m_retries = reg.counter(
            "relayrl_serving_client_retries_total",
            "inference request attempts beyond the first")
        self._m_nacked = reg.counter(
            "relayrl_serving_client_nacked_total",
            "overload nacks honored (slept retry_after_s, no breaker "
            "charge)")
        self._m_resyncs = reg.counter(
            "relayrl_serving_client_resyncs_total",
            "session resyncs performed (episode window resent after a "
            "NACK_SESSION_EVICTED or replica re-route)")
        self.active = False
        if start:
            self.enable_agent()

    # -- lifecycle --
    def enable_agent(self) -> None:
        if self.active:
            return
        import zlib

        from relayrl_tpu_torch.transport import make_agent_transport
        from relayrl_tpu_torch.transport.retry import RetryPolicy
        from relayrl_tpu_torch.transport.serving import make_serving_client

        overrides = dict(self._addr_overrides)
        overrides.setdefault("negotiate_window_s",
                             min(self._handshake_timeout_s * 0.5, 30.0))
        if self._identity is not None:
            overrides.setdefault("identity", self._identity)
        serving_overrides = {
            k: overrides.pop(k)
            for k in ("serving_addr", "serving_plane", "serving_addrs")
            if k in overrides}
        self.transport = make_agent_transport(
            self.server_type, self.config, **overrides)
        self._retry = RetryPolicy.from_dict(
            self.config.get_transport_params()["retry"])
        self._sids = [f"{self.transport.identity}#L{i:03d}"
                      for i in range(self.lanes)]
        self.trajectories = [
            Trajectory(max_length=self.config.get_max_traj_length(),
                       on_send=(lambda p, sid=sid: self._send_traj(sid, p)))
            for sid in self._sids]
        try:
            self.transport.register(self.transport.identity,
                                    timeout_s=10.0)
            for sid in self._sids:
                self.transport.register(sid, timeout_s=10.0)
        except Exception as e:
            print(f"[MultiplexedRemoteClient] registration failed "
                  f"(continuing unregistered): {e!r}", flush=True)
        self._bind_spool()
        # One streaming client per replica; lanes route session-affine.
        replicas = serving_overrides.pop("serving_addrs", None) \
            or self.config.get_serving_params()["replicas"]
        plane = serving_overrides.get("serving_plane") or (
            "grpc" if self.server_type == "grpc" else "zmq")
        if replicas and plane != "grpc":
            for addr in replicas:
                ov = dict(serving_overrides)
                ov.update(serving_addr=str(addr), stream=True)
                self._clients.append(make_serving_client(
                    self.server_type, self.config,
                    transport=self.transport, **ov))
        else:
            ov = dict(serving_overrides)
            ov["stream"] = True
            self._clients.append(make_serving_client(
                self.server_type, self.config, transport=self.transport,
                **ov))
        self._lane_client = [
            zlib.crc32(sid.encode()) % len(self._clients)
            for sid in self._sids]
        from relayrl_tpu_torch.runtime.agent import _start_fleet_emitter

        self._fleet_emitter = _start_fleet_emitter(self, "client")
        self.active = True
        from relayrl_tpu_torch import telemetry

        telemetry.emit("agent_register", agent_id=self.transport.identity,
                       side="agent", mode="remote-mux")

    def disable_agent(self) -> None:
        if not self.active:
            return
        from relayrl_tpu_torch.runtime.agent import _close_fleet_emitter

        drain_s = _close_fleet_emitter(self)
        if self.spool is not None:
            self.spool.send_fn = None
        for client in self._clients:
            try:
                client.close()
            except Exception:
                pass
        self._clients = []
        self.transport.close(drain_s=drain_s)
        self.transport = None
        self.active = False

    def _bind_spool(self) -> None:
        from relayrl_tpu_torch.runtime.agent import _bind_spool_impl

        _bind_spool_impl(self, self._identity or "remote-mux")

    def _send_traj(self, sid: str, payload: bytes) -> None:
        if self.spool is not None:
            self.spool.send(payload, sid)
            return
        from relayrl_tpu_torch.runtime.agent import _send_direct

        _send_direct(self.transport, payload, sid)

    @property
    def inflight_high_water(self) -> int:
        """Deepest concurrent request pipeline seen across replica
        connections — the streaming-actually-streams evidence the
        serving smoke asserts (≥2 means the lock-step era is over)."""
        return max((c.inflight_high_water for c in self._clients),
                   default=0)

    # -- action API (vector-shaped) --
    def request_for_actions(self, obs_batch, masks=None,
                            rewards=None) -> list[ActionRecord]:
        """One served action per lane, pipelined: every lane's request is
        submitted before any reply is awaited, so up to
        ``serving.stream_window`` requests ride each replica connection
        concurrently. Reward credit semantics are per-lane identical to
        ``PolicyActor.request_for_action``."""
        self._require_active()
        from relayrl_tpu_torch.runtime.policy_actor import normalize_obs

        n = len(obs_batch)
        if n != self.lanes:
            raise ValueError(f"expected {self.lanes} lane observations, "
                             f"got {n}")
        obs_list = [normalize_obs(o) for o in obs_batch]
        mask_list = [None if masks is None or masks[i] is None
                     else np.asarray(masks[i], np.float32)
                     for i in range(n)]
        with self._lock:
            if rewards is not None:
                for i in range(n):
                    if rewards[i] and self.trajectories[i].get_actions():
                        self.trajectories[i].get_actions()[-1] \
                            .update_reward(float(rewards[i]))
            # torchlint: disable=LOCK02 - per-client lock; the driving loop is serial, blocking here IS the backpressure
            replies = self._infer_all(obs_list, mask_list)
            records = []
            for i in range(n):
                act, aux = replies[i]
                record = ActionRecord(
                    obs=obs_list[i], act=act, mask=mask_list[i],
                    rew=0.0, data=aux, done=False)
                self.trajectories[i].add_action(record, send_if_done=True)
                records.append(record)
        self._m_steps.inc(n)
        return records

    def flag_last_action(self, lane: int, reward: float = 0.0,
                         truncated: bool = False, final_obs=None,
                         terminated: bool | None = None,
                         final_mask=None) -> None:
        """Per-lane terminal marker (vector-host semantics): ships the
        lane's episode and schedules the session-window reset flag for
        its next request."""
        self._require_active()
        if terminated:
            truncated = False
        with self._lock:
            self._episode_starts[lane] = True
            if self._mirrors[lane] is not None:
                self._mirrors[lane] = []
            record = ActionRecord(
                obs=(None if final_obs is None
                     else np.asarray(final_obs, np.float32)),
                mask=(None if final_mask is None
                      else np.asarray(final_mask, np.float32)),
                rew=float(reward), done=True, truncated=bool(truncated))
            self.trajectories[lane].add_action(record, send_if_done=True)

    # -- the pipelined infer engine --
    def _build(self, lane: int, obs, mask, req_id: int,
               with_win: bool) -> bytes:
        win = None
        if with_win and self._mirrors[lane]:
            win = np.stack(self._mirrors[lane])
        return pack_infer_request(
            self._sids[lane], req_id, self._keys[lane], obs, mask,
            session=self._sids[lane], reset=self._episode_starts[lane],
            window=win, step=self._session_steps[lane] + 1)

    def _infer_all(self, obs_list, mask_list) -> list:
        """Submit every lane, then collect with per-lane retry handling
        (overload → honor retry-after; evicted → resync with the lane
        mirror; timeout/stream-break → resubmit under fresh req ids,
        rotating dead replicas). Lanes are chunked into waves of
        ``stream_window`` per replica connection so the in-flight depth
        stays bounded."""
        deadline = time.monotonic() + self._infer_deadline_s
        results: list = [None] * len(obs_list)
        # Wave chunking per client connection.
        by_client: dict[int, list[int]] = {}
        for lane in range(len(obs_list)):
            by_client.setdefault(self._lane_client[lane], []).append(lane)
        waves: list[list[int]] = []
        w = max(1, int(self._stream_window))
        round_idx = 0
        while True:
            wave = []
            for lanes_ in by_client.values():
                wave.extend(lanes_[round_idx * w:(round_idx + 1) * w])
            if not wave:
                break
            waves.append(wave)
            round_idx += 1
        for wave in waves:
            inflight: dict[int, tuple] = self._submit_wave(
                wave, obs_list, mask_list)
            attempt = 0
            while inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    for lane, (waiter, _) in inflight.items():
                        self._clients[self._lane_client[lane]] \
                            .cancel(waiter.req_id)
                    raise RuntimeError(
                        f"multiplexed inference exhausted its "
                        f"{self._infer_deadline_s:.0f}s budget with "
                        f"{len(inflight)} lanes unserved")
                retry_lanes: list[tuple[int, bool]] = []
                nap = 0.0
                for lane in list(inflight):
                    waiter, req_id = inflight.pop(lane)
                    client = self._clients[self._lane_client[lane]]
                    try:
                        reply = client.wait(
                            waiter, min(self._request_timeout_s,
                                        max(0.05, remaining)))
                    except (TimeoutError, ConnectionError, OSError):
                        self._m_retries.inc()
                        if len(self._clients) > 1:
                            # Re-route: next replica; its eviction nack
                            # resyncs the session there.
                            self._lane_client[lane] = \
                                (self._lane_client[lane] + 1) \
                                % len(self._clients)
                        retry_lanes.append((lane, False))
                        continue
                    outcome = self._apply_reply(lane, obs_list[lane],
                                                reply)
                    if outcome == "ok":
                        results[lane] = (reply["act"], reply["aux"])
                    elif outcome == "resync":
                        retry_lanes.append((lane, True))
                    else:  # overloaded (or retryable error)
                        nap = max(nap, reply.get("retry_after_s")
                                  or self._retry_after_default)
                        retry_lanes.append((lane, False))
                if nap > 0:
                    time.sleep(min(nap,
                                   max(0.0,
                                       deadline - time.monotonic())))
                elif retry_lanes:
                    time.sleep(min(self._retry.delay(attempt), 0.2))
                for lane, with_win in retry_lanes:
                    inflight[lane] = self._submit_lane(
                        lane, obs_list[lane], mask_list[lane],
                        with_win=with_win)
                if retry_lanes:
                    attempt += 1
        return results

    def _submit_lane(self, lane: int, obs, mask,
                     with_win: bool) -> tuple:
        self._req_counter += 1
        req_id = self._req_counter
        payload = self._build(lane, obs, mask, req_id, with_win)
        waiter = self._clients[self._lane_client[lane]].submit(
            payload, req_id)
        return waiter, req_id

    def _submit_wave(self, lanes: list[int], obs_list,
                     mask_list) -> dict[int, tuple]:
        """Initial submits, coalesced: one ``pack_infer_wave`` frame per
        replica connection with stacked obs/key blocks — the wire-cost
        amortization that lets a saturated-core fleet clear the
        lock-step plateau. Falls back to per-lane frames for clients
        without a wave surface (grpc bidi) or heterogeneous lanes;
        retries and resyncs always ride the single-request wire."""
        out: dict[int, tuple] = {}
        by_client: dict[int, list[int]] = {}
        for lane in lanes:
            by_client.setdefault(self._lane_client[lane], []).append(lane)
        for ci, group in by_client.items():
            client = self._clients[ci]
            shapes = {(obs_list[lane].shape, str(obs_list[lane].dtype))
                      for lane in group}
            if (len(group) < 2 or not hasattr(client, "submit_wave")
                    or len(shapes) != 1
                    or any(mask_list[lane] is not None for lane in group)):
                for lane in group:
                    out[lane] = self._submit_lane(
                        lane, obs_list[lane], mask_list[lane],
                        with_win=False)
                continue
            entries, req_ids = [], []
            for lane in group:
                self._req_counter += 1
                req_ids.append(self._req_counter)
                entries.append({
                    "id": self._sids[lane], "req": self._req_counter,
                    "key": self._keys[lane], "obs": obs_list[lane],
                    "mask": None, "sid": self._sids[lane],
                    "stp": self._session_steps[lane] + 1,
                    "rst": self._episode_starts[lane]})
            waiters = client.submit_wave(pack_infer_wave(entries), req_ids)
            for lane, waiter, req_id in zip(group, waiters, req_ids):
                out[lane] = (waiter, req_id)
        return out

    def _apply_reply(self, lane: int, obs, reply: dict) -> str:
        from relayrl_tpu_torch.transport.base import NACK_SESSION_EVICTED

        code = reply["code"]
        if code == NACK_SESSION_EVICTED:
            self._m_resyncs.inc()
            return "resync"
        if code == NACK_OVERLOADED:
            self._m_nacked.inc()
            return "overloaded"
        if code == NACK_UNAVAILABLE:
            raise RuntimeError(f"inference unavailable: {reply['error']}")
        if code != NACK_OK or "act" not in reply:
            return "overloaded"  # code-0 error: retryable
        self._keys[lane] = np.frombuffer(
            reply["key"], dtype=self._keys[lane].dtype).copy()
        self.version = reply["ver"]
        self._session_steps[lane] += 1
        self._episode_starts[lane] = False
        ctx = reply.get("ctx")
        if ctx is None:
            self._mirrors[lane] = None
        elif self._mirrors[lane] is not None:
            self._mirrors[lane].append(obs)
            if len(self._mirrors[lane]) > ctx:
                del self._mirrors[lane][:len(self._mirrors[lane]) - ctx]
        return "ok"

    @property
    def model_version(self) -> int:
        return self.version

    def _require_active(self) -> None:
        if not self.active or not self._clients:
            raise RuntimeError(
                "multiplexed remote client is not active "
                "(call enable_agent())")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.disable_agent()


class StandaloneInferenceHost:
    """An InferenceService on dedicated devices: subscribes to the model
    plane over any agent transport exactly like an actor (handshake →
    wire-v2 deltas → shared swap gate) and serves the zmq ROUTER action
    plane. The Sebulba "dedicated inference devices" placement; the
    colocated placement lives inside TrainingServer (zero wire hops).
    """

    def __init__(self, config_path: str | None = None,
                 server_type: str = "zmq", serving_addr: str | None = None,
                 handshake_timeout_s: float = 60.0, start: bool = True,
                 device=None, **addr_overrides):
        from relayrl_tpu_torch.config import ConfigLoader
        from relayrl_tpu_torch.transport import make_agent_transport

        self.config = ConfigLoader(None, config_path)
        from relayrl_tpu_torch import telemetry

        telemetry.configure_from_config(self.config)
        self.transport = make_agent_transport(server_type, self.config,
                                              **addr_overrides)
        version, bundle_bytes = self.transport.fetch_model(
            handshake_timeout_s)
        bundle = ModelBundle.from_bytes(bundle_bytes)
        bundle.version = version
        self.service = InferenceService.from_config(bundle, self.config,
                                                    device=device)
        self.service.bind_zmq(
            serving_addr or self.config.get_inference_server().address)
        self.transport.on_model = self._on_model
        self.active = False
        if start:
            self.start()

    def _on_model(self, version: int, blob: bytes) -> None:
        from relayrl_tpu_torch.transport.modelwire import WireBaseMismatch

        try:
            self.service.swap_from_wire(version, blob)
        except WireBaseMismatch:
            self.transport.request_resync()
        except Exception as e:
            print(f"[StandaloneInferenceHost] rejected model update: "
                  f"{e!r}", flush=True)

    def start(self) -> None:
        if self.active:
            return
        self.service.start()
        self.transport.start_model_listener()
        self.active = True

    def stop(self) -> None:
        if not self.active:
            return
        self.service.stop()
        self.transport.close()
        self.active = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


__all__ = ["InferenceService", "InferRequest", "RemoteActorClient",
           "MultiplexedRemoteClient", "StandaloneInferenceHost",
           "default_buckets", "prng_key", "CLOSE_SIZE", "CLOSE_DEADLINE"]
