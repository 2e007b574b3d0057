"""Serving wire plane: the request/response action channel for thin-client
actors (the disaggregated batched-inference tier).

The trajectory/model planes are one-way (PUSH ingest, PUB model fan-out);
batched inference needs the missing fourth lane — a request/response pair
per action. TorchBeast's dynamic-batching server (arXiv:1910.03552) and
Podracer's Sebulba split (arXiv:2104.06272) are the exemplars: actors ship
observations, the service closes latency-bounded batches, one policy
dispatch answers everyone.

Backends:

* **zmq** — a dedicated ROUTER (service) / DEALER (client) pair on the
  ``server.inference_server`` endpoint. Replies are produced on the
  batch-worker thread but zmq sockets are single-threaded, so the worker
  hands them to the ROUTER loop over an inproc PUSH/PULL pipe (the same
  pattern libzmq documents for cross-thread sends).
* **grpc** — an in-band ``GetActions`` unary RPC on the existing service
  (pure-grpcio ``GrpcServerTransport`` only: the RPC thread blocks until
  its batch executes, the thread pool bounds concurrent clients). The
  native C++ gRPC server does not speak this RPC — those fleets use the
  zmq plane below.
* **native** — passthrough: the framed-TCP core carries trajectories and
  models; inference rides the zmq ROUTER plane bound alongside it (the
  service binds it regardless of the fleet's trajectory transport).

Wire codec (msgpack, raw array bytes — no per-element boxing):

* request  ``{id, req, key, kd, obs, os, od, mask?, ms?}`` — the client's
  CURRENT key (``uint32[2]``) rides the request; the service draws the
  row's noise and its successor key from that key alone (the keyed
  batched steps of :mod:`relayrl_tpu_torch.runtime.policy_actor`) and
  returns the successor in the reply. That is what makes a served action
  stream equal to the keyed step called locally on the same keys.
* reply    ``{req, code: 1, ver, act, as, ad, key, aux}`` with ``aux``
  mapping name → ``[bytes, shape, dtype]``.
* nack     ``{req, code, error, retry_after_s}`` — ``code`` reuses the
  typed ingest verdicts (``base.NACK_OVERLOADED`` when the batching queue
  is at ``serving.queue_limit``; the client honors ``retry_after_s``
  without charging its circuit breaker, mirroring the spool's nack
  handling).

A copy of :mod:`relayrl_tpu.transport.serving` with ``msgpack`` imported
inside the functions that encode and decode, so importing the port does
not load it; the frames are byte for byte the JAX package's.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

import numpy as np

from relayrl_tpu_torch.transport.base import NACK_OK


def _pack_array(arr: np.ndarray) -> tuple[bytes, list, str]:
    arr = np.asarray(arr)
    # Shape captured BEFORE ascontiguousarray: it promotes 0-d arrays to
    # 1-d, and scalar actions/aux must round-trip as exact 0-d ndarrays
    # (the vector-host wire-dtype lesson applies to shape too).
    shape = list(arr.shape)
    return np.ascontiguousarray(arr).tobytes(), shape, str(arr.dtype)


def _unpack_array(buf: bytes, shape: list, dtype: str) -> np.ndarray:
    # .copy(): frombuffer views are read-only and alias the wire frame;
    # ActionRecords built from them must own their memory.
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()


def pack_infer_request(agent_id: str, req_id: int, key: np.ndarray,
                       obs: np.ndarray, mask: np.ndarray | None,
                       session: str | None = None, reset: bool = False,
                       window: np.ndarray | None = None,
                       step: int = 0) -> bytes:
    """``session``/``reset``/``window`` are the serving-v2 per-session
    fields (absent on the v1 wire — old clients and old services
    interoperate): ``session`` names the server-side rolling window a
    sequence policy serves from; ``reset`` marks an episode start (the
    service zeroes the window BEFORE pushing this observation);
    ``window`` is the resync payload — the episode's prior observations
    ``[n, obs_dim]`` (oldest first, excluding the current ``obs``) that
    rebuilds the session after a NACK_SESSION_EVICTED or on a fresh
    replica after re-route."""
    import msgpack

    kb, _, kd = _pack_array(key)
    ob, oshape, od = _pack_array(obs)
    req = {"id": agent_id, "req": int(req_id),
           "key": kb, "kd": kd, "obs": ob, "os": oshape, "od": od}
    if mask is not None:
        mb, mshape, _ = _pack_array(np.asarray(mask, np.float32))
        req["mask"] = mb
        req["ms"] = mshape
    if session is not None:
        req["sid"] = str(session)
        # Per-episode step counter (1-based, counting this observation):
        # the service's push-idempotency key. A client retry of a served
        # request whose reply was lost arrives with the SAME stp — the
        # service recomputes from the already-pushed window instead of
        # pushing the observation twice (same client key → bit-identical
        # recompute), so at-least-once delivery cannot corrupt state.
        req["stp"] = int(step)
    if reset:
        req["rst"] = True
    if window is not None:
        wb, wshape, _ = _pack_array(np.asarray(window, np.float32))
        req["win"] = wb
        req["ws"] = wshape
    return msgpack.packb(req, use_bin_type=True)


def unpack_infer_request(buf: bytes) -> dict:
    """Decoded request: ``{id, req, key, obs, mask, sid, rst, win}`` with
    numpy arrays (``sid``/``win`` None and ``rst`` False on the v1 wire).
    Raises the transport plane's droppable error classes on malformed
    frames (ValueError/KeyError/TypeError)."""
    import msgpack

    return _infer_request_fields(msgpack.unpackb(buf, raw=False))


def _infer_request_fields(req: dict) -> dict:
    key = np.frombuffer(req["key"], dtype=np.dtype(req.get("kd", "uint32")))
    out = {
        "id": str(req.get("id", "?")),
        "req": int(req["req"]),
        "key": key.copy(),
        "obs": _unpack_array(req["obs"], req["os"], req["od"]),
        "mask": None,
        "sid": None if req.get("sid") is None else str(req["sid"]),
        "rst": bool(req.get("rst", False)),
        "stp": int(req.get("stp", 0)),
        "win": None,
    }
    if req.get("mask") is not None:
        out["mask"] = _unpack_array(req["mask"], req["ms"], "float32")
    if req.get("win") is not None:
        out["win"] = _unpack_array(req["win"], req["ws"], "float32")
    return out


def pack_action_reply(req_id: int, version: int, act: np.ndarray,
                      next_key: np.ndarray, aux: dict,
                      ctx: int | None = None) -> bytes:
    import msgpack

    reply = {"req": int(req_id), "code": NACK_OK, "ver": int(version),
             "key": _pack_array(next_key)[0],
             "aux": {k: list(_pack_array(v)) for k, v in aux.items()}}
    ab, ashape, ad = _pack_array(act)
    reply.update({"act": ab, "as": ashape, "ad": ad})
    if ctx is not None:
        # Session-served replies carry the service's window length so
        # the client can bound its resync mirror to exactly the rows a
        # resync could ever need (sequence policies only).
        reply["ctx"] = int(ctx)
    return msgpack.packb(reply, use_bin_type=True)


def pack_infer_nack(req_id: int, code: int, reason: str,
                    retry_after_s: float = 0.0) -> bytes:
    import msgpack

    return msgpack.packb({"req": int(req_id), "code": int(code),
                          "error": str(reason),
                          "retry_after_s": float(retry_after_s)},
                         use_bin_type=True)


def unpack_infer_reply(buf: bytes) -> dict:
    """Decoded reply: ``{req, code, ...}`` — on code 1 additionally
    ``ver``, ``act`` (ndarray), ``key`` (the carried-forward PRNG key
    bytes, kept raw: the client round-trips them verbatim), ``aux``
    (name → 0-d/array ndarray)."""
    import msgpack

    return _infer_reply_fields(msgpack.unpackb(buf, raw=False))


def _infer_reply_fields(reply: dict) -> dict:
    out = {"req": int(reply.get("req", -1)), "code": int(reply.get("code", 0)),
           "error": str(reply.get("error") or ""),
           "retry_after_s": float(reply.get("retry_after_s") or 0.0)}
    if out["code"] == NACK_OK and "act" in reply:
        out["ver"] = int(reply.get("ver", -1))
        out["act"] = _unpack_array(reply["act"], reply["as"], reply["ad"])
        out["key"] = reply["key"]
        out["aux"] = {k: _unpack_array(*v)
                      for k, v in (reply.get("aux") or {}).items()}
        if reply.get("ctx") is not None:
            out["ctx"] = int(reply["ctx"])
    return out


# -- wave frames (coalesced wire) -------------------------------------------
#
# A multiplexing client's per-step wire cost is dominated by per-request
# overhead — one msgpack round + one socket hop each way per lane
# (~190us/step measured on the bench host, ~40% of the total step
# budget). Pipelining alone cannot reclaim it on a saturated core: there
# is no latency to hide, only work to amortize. Wave frames carry a
# whole homogeneous wave in ONE frame with STACKED tensors (one obs
# block, one key block), and the service coalesces replies the same way
# per dispatched batch — per-lane codec cost drops to near zero while
# the decoded rows stay bit-identical to the single-request wire (the
# parity lock covers both).


def pack_infer_wave(entries: list[dict]) -> bytes:
    """One frame for a wave of lane requests. ``entries`` rows:
    ``{id, req, key, obs, mask, sid, stp, rst}``. The caller guarantees
    homogeneity (same obs shape/dtype, same key dtype, masks all None or
    all present at one shape) and that no row carries a resync window —
    resyncs and retries always ride the single-request wire."""
    import msgpack

    keys = np.stack([np.asarray(e["key"]) for e in entries])
    obs = np.stack([np.asarray(e["obs"]) for e in entries])
    kb, ks, kd = _pack_array(keys)
    ob, oshape, od = _pack_array(obs)
    wave = {"wave": 1,
            "reqs": [int(e["req"]) for e in entries],
            "ids": [str(e["id"]) for e in entries],
            "key": kb, "ks": ks, "kd": kd,
            "obs": ob, "os": oshape, "od": od}
    if entries[0].get("mask") is not None:
        mb, mshape, _ = _pack_array(np.stack(
            [np.asarray(e["mask"], np.float32) for e in entries]))
        wave["mask"] = mb
        wave["ms"] = mshape
    if entries[0].get("sid") is not None:
        # Session rows: sid == id on the mux wire (one session per lane
        # sid), so only the step/reset columns ship.
        wave["ses"] = True
        wave["stps"] = [int(e.get("stp", 0)) for e in entries]
        wave["rst"] = [1 if e.get("rst") else 0 for e in entries]
    return msgpack.packb(wave, use_bin_type=True)


def _unpack_infer_wave(req: dict) -> list[dict]:
    keys = _unpack_array(req["key"], req["ks"], req["kd"])
    obs = _unpack_array(req["obs"], req["os"], req["od"])
    masks = None
    if req.get("mask") is not None:
        masks = _unpack_array(req["mask"], req["ms"], "float32")
    ids = [str(s) for s in req["ids"]]
    ses = bool(req.get("ses"))
    stps = req.get("stps") or [0] * len(ids)
    rsts = req.get("rst") or [0] * len(ids)
    # Rows are views of the one decoded (owned) block — downstream
    # writes copy (np.stack at dispatch, window-row assignment), so the
    # shared base is never mutated.
    return [{"id": ids[i], "req": int(req["reqs"][i]),
             "key": keys[i], "obs": obs[i],
             "mask": None if masks is None else masks[i],
             "sid": ids[i] if ses else None,
             "rst": bool(rsts[i]), "stp": int(stps[i]), "win": None}
            for i in range(len(ids))]


def unpack_infer_any(buf: bytes) -> list[dict]:
    """Decode either wire shape into request rows: a wave frame expands
    to its lanes, a single request becomes a one-row list."""
    import msgpack

    req = msgpack.unpackb(buf, raw=False)
    if req.get("wave"):
        return _unpack_infer_wave(req)
    return [_infer_request_fields(req)]


def pack_reply_wave(req_ids: list, version: int, acts: np.ndarray,
                    keys: np.ndarray, aux: dict,
                    ctx: int | None = None) -> bytes:
    """One frame answering several batchmates from one wave: stacked
    act/key/aux blocks (first axis = the wave rows), one shared version
    (a dispatch batch is single-model-version by construction)."""
    import msgpack

    reply = {"wave": 1, "reqs": [int(r) for r in req_ids],
             "code": NACK_OK, "ver": int(version)}
    ab, ashape, ad = _pack_array(acts)
    kb, ks, kd = _pack_array(keys)
    reply.update({"act": ab, "as": ashape, "ad": ad,
                  "key": kb, "ks": ks, "kd": kd,
                  "aux": {k: list(_pack_array(v)) for k, v in aux.items()}})
    if ctx is not None:
        reply["ctx"] = int(ctx)
    return msgpack.packb(reply, use_bin_type=True)


def _unpack_reply_wave(reply: dict) -> list[dict]:
    acts = _unpack_array(reply["act"], reply["as"], reply["ad"])
    keys = _unpack_array(reply["key"], reply["ks"], reply["kd"])
    aux = {k: _unpack_array(*v)
           for k, v in (reply.get("aux") or {}).items()}
    ctx = reply.get("ctx")
    ver = int(reply.get("ver", -1))
    out = []
    for i in range(len(reply["reqs"])):
        # ``[i, ...]`` keeps 0-d rows as 0-d ndarrays (never numpy
        # scalars) — the single-reply wire's exact dtype contract.
        row = {"req": int(reply["reqs"][i]), "code": NACK_OK,
               "error": "", "retry_after_s": 0.0, "ver": ver,
               "act": acts[i, ...],
               "key": keys[i].tobytes(),
               "aux": {k: v[i, ...] for k, v in aux.items()}}
        if ctx is not None:
            row["ctx"] = int(ctx)
        out.append(row)
    return out


def unpack_reply_any(buf: bytes) -> list[dict]:
    """Decode either reply shape into reply rows (nacks are always
    single frames — only served actions coalesce)."""
    import msgpack

    reply = msgpack.unpackb(buf, raw=False)
    if reply.get("wave"):
        return _unpack_reply_wave(reply)
    return [_infer_reply_fields(reply)]


# -- server side ------------------------------------------------------------

class ZmqServingPlane:
    """ROUTER request loop + inproc reply pipe for the InferenceService.

    ``on_request(payload: bytes, reply: Callable[[bytes], None])`` runs on
    the ROUTER loop thread (decode + enqueue only — the batching queue is
    the service's); ``reply`` may be called from ANY thread (the batch
    worker) and forwards the encoded reply to the requesting DEALER
    through the inproc pipe, so the ROUTER socket is only ever touched by
    its own loop thread.
    """

    def __init__(self, addr: str,
                 on_request: Callable[[bytes, Callable[[bytes], None]], None]):
        import zmq

        self._zmq = zmq
        self._addr = addr
        self.on_request = on_request
        self._ctx = zmq.Context.instance()
        self._inproc = f"inproc://relayrl-serving-{id(self):x}"
        self._router: object | None = None
        self._pull: object | None = None
        self._push: object | None = None
        self._push_lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    def start(self) -> None:
        if self._thread is not None:
            return
        zmq = self._zmq
        from relayrl_tpu_torch.transport.zmq_backend import _bind_with_retry

        self._stop.clear()
        self._router = self._ctx.socket(zmq.ROUTER)
        _bind_with_retry(self._router, self._addr)
        # inproc: the PULL must bind before any PUSH connects.
        self._pull = self._ctx.socket(zmq.PULL)
        self._pull.bind(self._inproc)
        self._push = self._ctx.socket(zmq.PUSH)
        self._push.connect(self._inproc)
        self._thread = threading.Thread(
            target=self._loop, name="zmq-serving-router", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        # Forward any replies still in the inproc pipe (the shutdown
        # nacks the service just sent) before tearing the ROUTER down —
        # the loop thread has exited, so this thread owns the sockets.
        if self._pull is not None and self._router is not None:
            zmq = self._zmq
            try:
                while self._pull.poll(0):
                    self._router.send_multipart(
                        self._pull.recv_multipart(zmq.NOBLOCK))
            except zmq.ZMQError:
                pass
        for sock in (self._router, self._pull, self._push):
            if sock is not None:
                sock.close(linger=0)
        self._router = self._pull = self._push = None

    def _reply_fn(self, identity: bytes) -> Callable[[bytes], None]:
        def reply(payload: bytes) -> None:
            # The push socket is shared across batch-worker callers; the
            # lock serializes whole sends (the ZmqAgentTransport
            # _push_lock precedent). A reply after stop() drops silently
            # — the client's retry owns that window.
            with self._push_lock:
                if self._push is not None:
                    self._push.send_multipart([identity, payload])
        return reply

    def _loop(self) -> None:
        zmq = self._zmq
        from relayrl_tpu_torch.transport.base import swallow_decode_error

        poller = zmq.Poller()
        poller.register(self._router, zmq.POLLIN)
        poller.register(self._pull, zmq.POLLIN)
        while not self._stop.is_set():
            events = dict(poller.poll(100))
            if self._pull in events:
                # Drain every queued reply before the next request sweep:
                # replies are latency-critical (the client is blocked on
                # them) and cheap (one forward per reply).
                while True:
                    try:
                        frames = self._pull.recv_multipart(zmq.NOBLOCK)
                    except zmq.Again:
                        break
                    self._router.send_multipart(frames)
            if self._router in events:
                frames = self._router.recv_multipart()
                if len(frames) < 2:
                    continue
                identity, payload = frames[0], frames[-1]
                try:
                    self.on_request(payload, self._reply_fn(identity))
                except Exception as e:
                    swallow_decode_error("zmq", "serving_request", e)


# -- client side ------------------------------------------------------------

class ZmqServingClient:
    """One DEALER against the service's ROUTER. ``request`` is strictly
    request/response per caller (the thin client's env loop is serial);
    stale replies — answers to earlier attempts that timed out client-side
    — are discarded by request-id match, so a retry can never consume its
    predecessor's action."""

    def __init__(self, addr: str, identity: str | None = None):
        import os
        import secrets

        import zmq

        self._zmq = zmq
        self._ctx = zmq.Context.instance()
        self._sock = self._ctx.socket(zmq.DEALER)
        self._sock.setsockopt(
            zmq.IDENTITY,
            (identity or f"INFER-{os.getpid()}{secrets.token_hex(4)}")
            .encode())
        self._sock.connect(addr)
        self._lock = threading.Lock()

    def request(self, payload: bytes, req_id: int,
                timeout_s: float) -> dict:
        """Send one request and wait for ITS reply (req-id matched).
        Raises TimeoutError when nothing matching arrives in time."""
        zmq = self._zmq
        with self._lock:
            # Drain leftovers from PREVIOUS requests before sending:
            # a late reply (or req=-1 nack) to an attempt that already
            # timed out must not be adopted by THIS request — clearing
            # the buffer first shrinks the -1 branch's ambiguity window
            # to replies generated after this send.
            try:
                while self._sock.poll(0):
                    # NOBLOCK recv after a 0-timeout poll: returns
                    # immediately by construction, never blocks the lock.
                    self._sock.recv(zmq.NOBLOCK)  # torchlint: disable=CONC01
            except zmq.ZMQError:
                pass
            self._sock.send(payload)
            deadline = time.monotonic() + timeout_s
            poller = zmq.Poller()
            poller.register(self._sock, zmq.POLLIN)
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"inference reply not received in {timeout_s:.2f}s")
                if not dict(poller.poll(max(1, int(remaining * 1000)))):
                    continue
                # deliberate blocking-under-lock: the lock EXISTS to
                # serialize whole request/reply exchanges on the
                # non-thread-safe DEALER (the _dealer_request precedent);
                # poll() above guarantees recv returns immediately and
                # the hold is bounded by the caller's timeout_s.
                raw = self._sock.recv()  # torchlint: disable=CONC01
                try:
                    reply = unpack_infer_reply(raw)
                except Exception:
                    continue  # corrupt frame: wait out the deadline
                if reply["req"] == req_id:
                    return reply
                if reply["req"] == -1 and reply["code"] != NACK_OK:
                    # The service could not decode the request, so its
                    # error/unavailable reply carries req=-1. This
                    # client is strictly one-request-outstanding, so the
                    # verdict is unambiguously OURS — returning it makes
                    # a corrupted request a fast error-reply retry
                    # (the agent.infer chaos contract) instead of a full
                    # timeout + an unearned breaker charge.
                    return reply
                # stale reply from a timed-out earlier attempt: discard

    def close(self) -> None:
        self._sock.close(linger=0)


class StreamWaiter:
    """One in-flight streamed request: ``wait`` blocks for ITS reply
    (req-id matched by the receiver loop). ``reply`` is None until
    delivery; a waiter failed wholesale (stream broke, client closing)
    completes with ``error`` set instead."""

    __slots__ = ("req_id", "event", "reply", "error")

    def __init__(self, req_id: int):
        self.req_id = int(req_id)
        self.event = threading.Event()
        self.reply: dict | None = None
        self.error: str | None = None

    def resolve(self, reply: dict) -> None:
        self.reply = reply
        self.event.set()

    def fail(self, error: str) -> None:
        self.error = error
        self.event.set()


class ZmqStreamingClient:
    """Pipelined DEALER against the service's ROUTER: N requests in
    flight per client, replies matched by request id, out-of-order
    completion legal — the serving-v2 stream channel that lets one thin
    process drive dozens of env lanes over in-flight windows instead of
    lock-step round-trips.

    The DEALER is owned by ONE receiver thread (zmq sockets are not
    thread-safe); submitting threads hand their frames to it over an
    inproc PUSH/PULL pipe (the ZmqServingPlane pattern, mirrored
    client-side), so a submit never waits on a reply and never touches
    the DEALER. ``inflight_high_water`` records the deepest concurrent
    pipeline seen — the bench/test evidence that streaming actually
    streams (≥2 asserted by the serving smoke)."""

    def __init__(self, addr: str, identity: str | None = None):
        import os
        import secrets

        import zmq

        self._zmq = zmq
        self._ctx = zmq.Context.instance()
        self._dealer = self._ctx.socket(zmq.DEALER)
        self._dealer.setsockopt(
            zmq.IDENTITY,
            (identity or f"INFER-{os.getpid()}{secrets.token_hex(4)}")
            .encode())
        self._dealer.connect(addr)
        self._inproc = f"inproc://relayrl-serving-cli-{id(self):x}"
        self._pull = self._ctx.socket(zmq.PULL)
        self._pull.bind(self._inproc)
        self._push = self._ctx.socket(zmq.PUSH)
        self._push.connect(self._inproc)
        self._push_lock = threading.Lock()
        self._pending: dict[int, StreamWaiter] = {}
        self._plock = threading.Lock()
        self.inflight_high_water = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="zmq-serving-stream", daemon=True)
        self._thread.start()

    def submit(self, payload: bytes, req_id: int) -> StreamWaiter:
        """Queue one request for send and return its waiter — returns
        immediately; the reply lands on the waiter whenever its batch
        executes, in any order relative to other in-flight requests."""
        waiter = StreamWaiter(req_id)
        with self._plock:
            if self._stop.is_set():
                waiter.fail("streaming client closed")
                return waiter
            self._pending[req_id] = waiter
            depth = len(self._pending)
            if depth > self.inflight_high_water:
                self.inflight_high_water = depth
        with self._push_lock:
            self._push.send(payload)
        return waiter

    def submit_wave(self, payload: bytes,
                    req_ids: list[int]) -> list[StreamWaiter]:
        """Queue one coalesced wave frame (``pack_infer_wave``) carrying
        several requests; returns one waiter per request, resolved
        independently (replies may coalesce differently than requests —
        the receiver matches by req id either way)."""
        waiters = [StreamWaiter(r) for r in req_ids]
        with self._plock:
            if self._stop.is_set():
                for waiter in waiters:
                    waiter.fail("streaming client closed")
                return waiters
            for waiter in waiters:
                self._pending[waiter.req_id] = waiter
            depth = len(self._pending)
            if depth > self.inflight_high_water:
                self.inflight_high_water = depth
        with self._push_lock:
            self._push.send(payload)
        return waiters

    def wait(self, waiter: StreamWaiter, timeout_s: float) -> dict:
        """Block for one waiter's reply. On timeout the waiter is
        RETRACTED (a late reply is dropped by the receiver, never
        adopted by a retry — retries carry fresh req ids)."""
        if not waiter.event.wait(timeout_s):
            self.cancel(waiter.req_id)
            # Resolve-vs-cancel race: the receiver may have completed
            # the waiter between the wait timeout and the pop.
            if not waiter.event.is_set():
                raise TimeoutError(
                    f"streamed inference reply not received in "
                    f"{timeout_s:.2f}s")
        if waiter.error is not None:
            raise ConnectionError(waiter.error)
        return waiter.reply

    def request(self, payload: bytes, req_id: int, timeout_s: float) -> dict:
        """Serial-compatible surface (ZmqServingClient drop-in): submit
        and wait. Callers that never overlap submits get exactly the
        lock-step behavior, over the same pipelined channel."""
        return self.wait(self.submit(payload, req_id), timeout_s)

    def cancel(self, req_id: int) -> None:
        with self._plock:
            self._pending.pop(req_id, None)

    def _loop(self) -> None:
        zmq = self._zmq
        poller = zmq.Poller()
        poller.register(self._dealer, zmq.POLLIN)
        poller.register(self._pull, zmq.POLLIN)
        while not self._stop.is_set():
            events = dict(poller.poll(100))
            if self._pull in events:
                while True:
                    try:
                        frame = self._pull.recv(zmq.NOBLOCK)
                    except zmq.ZMQError:
                        break
                    self._dealer.send(frame)
            if self._dealer in events:
                while True:
                    try:
                        raw = self._dealer.recv(zmq.NOBLOCK)
                    except zmq.ZMQError:
                        break
                    try:
                        rows = unpack_reply_any(raw)
                    except Exception:
                        continue  # corrupt frame: its waiters time out
                    for reply in rows:
                        with self._plock:
                            waiter = self._pending.pop(reply["req"], None)
                        # req=-1 decode-failure nacks are ambiguous on a
                        # pipelined channel (unlike the serial client's
                        # one-outstanding adoption rule) — unmatched
                        # replies drop and the affected waiter retries
                        # on timeout.
                        if waiter is not None:
                            waiter.resolve(reply)

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        with self._plock:
            pending, self._pending = list(self._pending.values()), {}
        for waiter in pending:
            waiter.fail("streaming client closed")
        with self._push_lock:
            # Under the send lock: a racing submit that passed the _stop
            # check must finish its send before the socket dies.
            self._push.close(linger=0)
        for sock in (self._dealer, self._pull):
            sock.close(linger=0)


class GrpcServingClient:
    """In-band ``GetActions`` unary RPC on the agent's existing channel
    (pure-grpcio fleets). The request/response pairing is the RPC itself,
    so there is no stale-reply window to filter."""

    def __init__(self, agent_transport):
        import grpc

        self._grpc = grpc
        self._transport = agent_transport
        self._stub = None
        self._stub_channel = None

    def _get_stub(self):
        # The agent transport may rebuild its channel after a persistent
        # break (_rebuild_channel); re-derive the stub when it did.
        channel = self._transport._channel
        if self._stub is None or self._stub_channel is not channel:
            self._stub = channel.unary_unary(
                "/relayrl.RelayRLRoute/GetActions",
                request_serializer=lambda x: x,
                response_deserializer=lambda x: x)
            self._stub_channel = channel
        return self._stub

    def request(self, payload: bytes, req_id: int,
                timeout_s: float) -> dict:
        grpc = self._grpc
        try:
            raw = self._get_stub()(payload, timeout=timeout_s)
        except grpc.RpcError as e:
            code = getattr(e, "code", lambda: None)()
            if code == grpc.StatusCode.DEADLINE_EXCEEDED:
                raise TimeoutError(
                    f"inference RPC deadline ({timeout_s:.2f}s)") from None
            if code == grpc.StatusCode.UNIMPLEMENTED:
                # PERMANENT: this server has no GetActions RPC at all —
                # the native C++ gRPC core. Retrying a misconfiguration
                # would bury it in a deadline exhaustion (the
                # NACK_UNAVAILABLE rationale); RuntimeError passes
                # through the client's retry loop uncaught.
                raise RuntimeError(
                    "inference unavailable: this gRPC server does not "
                    "implement GetActions (native C++ core?) — serve "
                    "inference on the zmq plane (serving_plane=\"zmq\") "
                    "or run the pure-grpcio server") from None
            raise ConnectionError(f"inference RPC failed: {e}") from None
        return unpack_infer_reply(raw)

    def close(self) -> None:
        pass  # the agent transport owns the channel


class GrpcStreamingClient:
    """Bidi ``StreamActions`` on the agent's existing channel — the grpc
    equivalent of :class:`ZmqStreamingClient`: N requests in flight,
    req-id matched, out-of-order replies legal. One long-lived
    stream-stream call carries every request; a broken stream fails the
    in-flight waiters (their owners retry) and the next submit opens a
    fresh call on whatever channel the transport currently holds (so a
    ``_rebuild_channel`` heal is picked up automatically)."""

    def __init__(self, agent_transport):
        import grpc

        self._grpc = grpc
        self._transport = agent_transport
        self._lock = threading.Lock()
        self._plock = threading.Lock()
        self._pending: dict[int, StreamWaiter] = {}
        self.inflight_high_water = 0
        self._queue = None          # outbound request queue of the live call
        self._receiver = None
        self._closed = False
        self._permanent: str | None = None

    def _ensure_stream_locked(self):
        import queue as queue_mod

        if self._queue is not None:
            return self._queue
        channel = self._transport._channel
        stub = channel.stream_stream(
            "/relayrl.RelayRLRoute/StreamActions",
            request_serializer=lambda x: x,
            response_deserializer=lambda x: x)
        q: "queue_mod.Queue[bytes | None]" = queue_mod.Queue()

        def request_iter():
            while True:
                item = q.get()
                if item is None:
                    return
                yield item

        responses = stub(request_iter())
        self._queue = q
        self._receiver = threading.Thread(
            target=self._recv_loop, args=(q, responses),
            name="grpc-serving-stream", daemon=True)
        self._receiver.start()
        return q

    def _recv_loop(self, q, responses) -> None:
        grpc = self._grpc
        error = "inference stream closed"
        try:
            for raw in responses:
                try:
                    reply = unpack_infer_reply(raw)
                except Exception:
                    continue
                with self._plock:
                    waiter = self._pending.pop(reply["req"], None)
                if waiter is not None:
                    waiter.resolve(reply)
        except grpc.RpcError as e:
            code = getattr(e, "code", lambda: None)()
            if code == grpc.StatusCode.UNIMPLEMENTED:
                # PERMANENT: no StreamActions RPC on this server (native
                # C++ core, or a pre-v2 pure-grpcio build) — same
                # misconfiguration contract as GetActions UNIMPLEMENTED.
                self._permanent = (
                    "inference unavailable: this gRPC server does not "
                    "implement StreamActions — serve inference on the "
                    "zmq plane (serving_plane=\"zmq\") or run a "
                    "serving-v2 pure-grpcio server")
                error = self._permanent
            else:
                error = f"inference stream broke: {e}"
        # Stream over (server gone, half-close, or error): fail every
        # in-flight waiter and let the next submit reopen.
        with self._lock:
            if self._queue is q:
                self._queue = None
                self._receiver = None
        with self._plock:
            pending, self._pending = list(self._pending.values()), {}
        for waiter in pending:
            waiter.fail(error)

    def submit(self, payload: bytes, req_id: int) -> StreamWaiter:
        waiter = StreamWaiter(req_id)
        if self._permanent is not None:
            raise RuntimeError(self._permanent)
        with self._lock:
            if self._closed:
                waiter.fail("streaming client closed")
                return waiter
            q = self._ensure_stream_locked()
            with self._plock:
                self._pending[req_id] = waiter
                depth = len(self._pending)
                if depth > self.inflight_high_water:
                    self.inflight_high_water = depth
            q.put(payload)
        return waiter

    def wait(self, waiter: StreamWaiter, timeout_s: float) -> dict:
        if not waiter.event.wait(timeout_s):
            with self._plock:
                self._pending.pop(waiter.req_id, None)
            if not waiter.event.is_set():
                raise TimeoutError(
                    f"streamed inference reply not received in "
                    f"{timeout_s:.2f}s")
        if waiter.error is not None:
            raise ConnectionError(waiter.error)
        return waiter.reply

    def request(self, payload: bytes, req_id: int, timeout_s: float) -> dict:
        return self.wait(self.submit(payload, req_id), timeout_s)

    def cancel(self, req_id: int) -> None:
        with self._plock:
            self._pending.pop(req_id, None)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            q, self._queue = self._queue, None
            receiver, self._receiver = self._receiver, None
        if q is not None:
            q.put(None)  # half-close; the receiver fails any stragglers
        if receiver is not None:
            receiver.join(timeout=5)


def make_serving_client(server_type: str, config, transport=None,
                        **overrides):
    """The thin client's action channel for a fleet transport kind:
    gRPC fleets ride the in-band ``GetActions`` RPC on the agent's
    existing channel; zmq and native fleets use the dedicated zmq
    DEALER against ``server.inference_server`` (native passthrough —
    the C++ core has no request/response action RPC). Pass
    ``serving_plane="zmq"`` to force the zmq plane on a grpc fleet whose
    server runs the native C++ gRPC core (it does not speak GetActions).
    ``stream=True`` returns the pipelined streaming client for the plane
    instead of the lock-step one (N in-flight requests, out-of-order
    replies — the serving-v2 channel)."""
    plane = overrides.get("serving_plane") or (
        "grpc" if server_type == "grpc" else "zmq")
    stream = bool(overrides.get("stream", False))
    if plane == "grpc":
        if transport is None or not hasattr(transport, "_channel"):
            raise ValueError(
                "grpc serving plane needs the agent's GrpcAgentTransport")
        return (GrpcStreamingClient(transport) if stream
                else GrpcServingClient(transport))
    addr = overrides.get("serving_addr")
    if addr is None:
        addr = config.get_inference_server().address
    cls = ZmqStreamingClient if stream else ZmqServingClient
    return cls(addr, identity=overrides.get("identity"))


__all__ = [
    "pack_infer_request", "unpack_infer_request", "pack_action_reply",
    "pack_infer_nack", "unpack_infer_reply", "ZmqServingPlane",
    "ZmqServingClient", "ZmqStreamingClient", "GrpcServingClient",
    "GrpcStreamingClient", "StreamWaiter", "make_serving_client",
]
