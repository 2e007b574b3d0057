"""Learner hot-path pipelining: async dispatch window + off-thread publish.

Counterpart of :mod:`relayrl_tpu.runtime.pipeline`. An eager PyTorch
update on the GPU returns once its kernels are queued, so the host can run
ahead of the device exactly as a jitted JAX dispatch does; these pieces
bound and fence that run-ahead:

* :class:`LazyMetrics` — an update's 0-d metric tensors, stacked on the
  device at dispatch and read to the host in ONE device-to-host copy when
  first read (never one ``.item()`` per metric).
* :class:`InflightWindow` — bounds how many dispatched-but-unfenced
  updates may be outstanding. Each entry carries a ``torch.cuda.Event``
  recorded after its update; a fence synchronizes on that event, then
  resolves the metrics. On the CPU every op is synchronous and an entry
  has no event: the fence is a no-op.
* :class:`PublishSnapshot` — the learner-thread handoff to the publisher:
  a device-side clone of the params taken on the learner's stream (the
  optimizer updates params in place, so the live tensors may move under a
  reader) plus an event recorded after the clone. The publisher thread
  waits on that event before its device-to-host read, so a publish never
  tears across two versions.
* :class:`ModelPublisher` — a dedicated thread fed latest-wins (a copy of
  the JAX package's): a slow socket or artifact write never stalls
  training, and back-to-back epochs coalesce into one publish.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Iterator, Mapping

import torch


def record_event(device: torch.device) -> "torch.cuda.Event | None":
    """A CUDA event recorded on the current stream of ``device`` (None on
    the CPU, where every op has finished when it returns)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


class LazyMetrics(Mapping):
    """Mapping view over an update's 0-d device metrics that resolves to
    host floats only when read. The values are stacked into one device
    vector at construction (queued behind the update, no host sync); the
    first read copies that vector to the host once, later reads are
    free."""

    def __init__(self, device_metrics: Mapping[str, Any]):
        self._device = dict(device_metrics)
        self._keys = list(self._device)
        self._stacked = (torch.stack([torch.as_tensor(v).detach().float()
                                      .reshape(()) for v in
                                      self._device.values()])
                         if self._device else None)
        self._host: dict[str, float] | None = None

    @property
    def device(self) -> dict[str, Any]:
        """The raw device tensors."""
        return self._device

    def resolve(self) -> dict[str, float]:
        if self._host is None:
            values = [] if self._stacked is None else self._stacked.tolist()
            self._host = dict(zip(self._keys, values))
        return self._host

    def __getitem__(self, key: str) -> float:
        return self.resolve()[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)

    def __repr__(self) -> str:
        state = "resolved" if self._host is not None else "in-flight"
        return f"LazyMetrics({sorted(self._keys)}, {state})"


class InflightWindow:
    """Bounded window of dispatched-but-unfenced updates.

    Every dispatch pushes the update's :class:`LazyMetrics` and the event
    recorded after it; pushing past ``max_in_flight`` fences the oldest
    first. ``max_in_flight=0`` fences every dispatch at once (the
    synchronous kill switch). Owned by the learner thread alone: no
    locks. ``device_wait_s`` accumulates the time blocked in fences so
    the server's ``timings`` can report it apart from dispatch work.
    """

    def __init__(self, max_in_flight: int = 2):
        from relayrl_tpu_torch import telemetry

        self.max_in_flight = max(0, int(max_in_flight))
        self._entries: deque[Any] = deque()
        self.dispatch_count = 0   # total updates ever pushed
        self.fenced_count = 0     # total updates known complete
        self.device_wait_s = 0.0
        reg = telemetry.get_registry()
        self._m_device_wait = reg.histogram(
            "relayrl_learner_device_wait_seconds",
            "learner thread blocked fencing an in-flight update")
        self._m_pending = reg.gauge(
            "relayrl_learner_inflight_pending",
            "dispatched-but-unfenced updates in the async window")

    @property
    def pending(self) -> int:
        """Dispatched-but-unfenced updates (the drain() contract)."""
        return len(self._entries)

    def push(self, metrics: LazyMetrics | None, event=None) -> None:
        """Record one dispatched update; blocks only when the window is
        already full (fencing the oldest)."""
        self._entries.append((metrics, event))
        self.dispatch_count += 1
        while len(self._entries) > self.max_in_flight:
            self._fence_oldest()
        self._m_pending.set(len(self._entries))

    def drain(self) -> None:
        """Fence every outstanding update (learner idle / shutdown /
        pre-checkpoint)."""
        while self._entries:
            self._fence_oldest()

    def _fence_oldest(self) -> None:
        metrics, event = self._entries.popleft()
        t0 = time.monotonic()
        if event is not None:
            event.synchronize()
        if metrics is not None:
            metrics.resolve()  # the update's one device-to-host copy
        dt = time.monotonic() - t0
        self.device_wait_s += dt
        self.fenced_count += 1
        self._m_device_wait.observe(dt)
        self._m_pending.set(len(self._entries))


@dataclasses.dataclass
class PublishSnapshot:
    """Learner-thread handoff to the publisher. ``state`` is a device
    clone of the params module's state dict, taken on the learner's
    stream; ``event`` was recorded after the clone (None on the CPU);
    ``to_host`` turns a host state dict into the flax params tree the
    wire carries. ``version`` is the host-side dispatch mirror."""

    version: int
    arch: dict
    state: dict
    event: Any = None
    to_host: Callable[[dict], Any] | None = None

    def host_params(self):
        """The blocking device-to-host read — runs on the publisher
        thread, never the learner thread. Waits for the clone first: the
        clone is queued behind every update dispatched before it, and the
        next update may already be moving the live params."""
        if self.event is None:
            host = {k: v.cpu() for k, v in self.state.items()}
        else:
            # A side stream waits on the clone's event, so the copy does
            # not queue behind updates dispatched after the snapshot.
            device = next(iter(self.state.values())).device
            with torch.cuda.device(device):
                stream = torch.cuda.Stream(device)
                stream.wait_event(self.event)
                with torch.cuda.stream(stream):
                    host = {k: v.to("cpu") for k, v in self.state.items()}
        return self.to_host(host) if self.to_host is not None else host


class ModelPublisher:
    """Dedicated publish thread fed latest-wins.

    ``submit`` replaces any not-yet-started snapshot (the dropped one
    counts as ``coalesced`` — back-to-back epochs fold into one publish
    of the newest params); the publish callable runs outside the lock so
    a slow socket/disk never blocks the submitting learner thread.
    ``pending`` counts the queued slot plus an in-progress publish, which
    is what extends the server ``drain()`` contract to "the final publish
    landed"."""

    def __init__(self, publish_fn: Callable[[PublishSnapshot], None],
                 name: str = "model-publisher"):
        from relayrl_tpu_torch import telemetry

        self._publish_fn = publish_fn
        self._cond = threading.Condition()
        self._slot: PublishSnapshot | None = None
        self._busy = False
        self._stop = False
        self.published = 0
        self.coalesced = 0
        self.errors = 0
        self.publish_s = 0.0
        reg = telemetry.get_registry()
        self._m_published = reg.counter(
            "relayrl_learner_publishes_total",
            "model publishes that landed (gather+serialize+send)")
        self._m_coalesced = reg.counter(
            "relayrl_learner_publish_coalesced_total",
            "queued publishes replaced latest-wins before starting")
        self._m_errors = reg.counter(
            "relayrl_learner_publish_errors_total",
            "publish attempts that raised (transient socket/fs)")
        self._m_publish = reg.histogram(
            "relayrl_learner_publish_seconds",
            "one publish on the publisher thread: D2H gather + serialize "
            "+ socket + artifact write")
        self._thread = threading.Thread(target=self._loop, name=name,
                                        daemon=True)
        self._thread.start()

    @property
    def pending(self) -> int:
        with self._cond:
            return int(self._slot is not None) + int(self._busy)

    def submit(self, snapshot: PublishSnapshot) -> None:
        with self._cond:
            if self._stop:
                return
            if self._slot is not None:
                self.coalesced += 1
                self._m_coalesced.inc()
            self._slot = snapshot
            self._cond.notify()

    def drain(self, timeout: float | None = None) -> bool:
        """Block until the queued + in-progress publishes have landed."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._slot is not None or self._busy:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(remaining)
        return True

    def stop(self, timeout: float | None = 30.0) -> None:
        """Finish the pending publish (if any), then join the thread."""
        with self._cond:
            self._stop = True
            self._cond.notify()
        self._thread.join(timeout)

    def _loop(self) -> None:
        while True:
            with self._cond:
                while self._slot is None and not self._stop:
                    self._cond.wait()
                if self._slot is None and self._stop:
                    return
                snapshot, self._slot = self._slot, None
                self._busy = True
            t0 = time.monotonic()
            try:
                self._publish_fn(snapshot)
                self.published += 1
                self._m_published.inc()
            except Exception as e:  # a transient socket/fs error must not
                self.errors += 1    # kill the publish plane
                self._m_errors.inc()
                print(f"[ModelPublisher] publish error: {e!r}", flush=True)
            finally:
                dt = time.monotonic() - t0
                self.publish_s += dt
                self._m_publish.observe(dt)
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()


__all__ = ["InflightWindow", "LazyMetrics", "ModelPublisher",
           "PublishSnapshot", "record_event"]
