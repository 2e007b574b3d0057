"""Profiling hooks: the torch.profiler twin of the JAX package's
jax.profiler surface (trace server, traces, scopes, timing).

* :func:`trace` captures the enclosed block with ``torch.profiler`` (the
  CPU activity, plus the CUDA activity when a card is present) and writes
  a Chrome trace into a directory (``chrome://tracing`` / Perfetto).
* :func:`annotate` names a range: a ``record_function`` scope on the
  profiler's timeline, plus an NVTX range on the card.
* :func:`timed` times a call with the device work it queued flushed.
* :func:`start_trace_server` captures on demand from outside the process,
  the role ``jax.profiler.start_server`` plays for the JAX package.

``torch`` is imported by the functions, never at import.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time


def _cuda_present() -> bool:
    import torch

    return torch.cuda.is_available()


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if _cuda_present():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _trace_path(log_dir: str) -> str:
    os.makedirs(log_dir, exist_ok=True)
    return os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture the enclosed block to a Chrome trace in ``log_dir``.

    Yields the ``torch.profiler.profile`` object; once the block exits its
    ``trace_path`` attribute names the JSON file written. Device work the
    block queued is synchronised before the capture stops, so kernels
    still in flight land in the trace."""
    import torch
    from torch.profiler import profile

    prof = profile(activities=_activities())
    prof.trace_path = None
    prof.start()
    try:
        yield prof
    finally:
        if _cuda_present() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        path = _trace_path(log_dir)
        prof.export_chrome_trace(path)
        prof.trace_path = path


@contextlib.contextmanager
def annotate(name: str):
    """Named range on the profiler timeline (``record_function``), and an
    NVTX range on the card for external timeline tools."""
    import torch

    nvtx = _cuda_present() and torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def timed(fn, *args, **kwargs):
    """(result, seconds) with the device work flushed: every CUDA device
    that holds a tensor of the result is synchronised before the clock
    stops, the counterpart of ``jax.block_until_ready``."""
    import torch
    from torch.utils._pytree import tree_leaves

    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    devices = {leaf.device for leaf in tree_leaves(out)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


class TraceServer:
    """An on-demand capture endpoint over the stdlib ``http.server``.

    Protocol (one capture at a time):

    * ``GET /capture?seconds=S`` profiles this process for ``S`` seconds
      (default 1, at most 600) into a new Chrome trace under the server's
      ``log_dir`` and answers ``200`` with ``{"trace": <path>, "seconds":
      S, "events": <count>}`` once the file is written. A second request
      while one runs gets ``409``; a malformed ``seconds`` gets ``400``.
    * ``GET /`` answers ``200`` with ``{"log_dir": ..., "captures": [...]}``
      (the paths written so far).

    The capture runs on the server's thread: CUDA kernels of every thread
    are recorded (the device activity is process-wide), CPU operators only
    where the profiler's thread-local hooks see them, so annotate the code
    of interest or use :func:`trace` in-line for a CPU view.
    """

    MAX_SECONDS = 600.0

    def __init__(self, port: int = 9999, log_dir: str = "profiles",
                 host: str = "127.0.0.1"):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import parse_qs, urlparse

        self.log_dir = log_dir
        self.captures: list[str] = []
        self._busy = threading.Lock()
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                return

            def _reply(self, code: int, doc: dict) -> None:
                body = (json.dumps(doc) + "\n").encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (http.server API)
                url = urlparse(self.path)
                if url.path == "/":
                    self._reply(200, {"log_dir": server.log_dir,
                                      "captures": list(server.captures)})
                    return
                if url.path != "/capture":
                    self._reply(404, {"error": f"no route {url.path}"})
                    return
                try:
                    seconds = float(parse_qs(url.query).get(
                        "seconds", ["1"])[0])
                    if not 0 < seconds <= server.MAX_SECONDS:
                        raise ValueError(seconds)
                except ValueError:
                    self._reply(400, {"error": "seconds must be in "
                                      f"(0, {server.MAX_SECONDS:g}]"})
                    return
                if not server._busy.acquire(blocking=False):
                    self._reply(409, {"error": "a capture is running"})
                    return
                try:
                    path, events = server.capture(seconds)
                finally:
                    server._busy.release()
                self._reply(200, {"trace": path, "seconds": seconds,
                                  "events": events})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="trace-server",
            daemon=True)
        self._thread.start()

    def capture(self, seconds: float) -> tuple[str, int]:
        with trace(self.log_dir) as prof:
            time.sleep(seconds)
        events = len(prof.events())
        self.captures.append(prof.trace_path)
        return prof.trace_path, events

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


def start_trace_server(port: int = 9999, log_dir: str = "profiles",
                       host: str = "127.0.0.1") -> TraceServer:
    """Start the on-demand capture endpoint (:class:`TraceServer`; port 0
    picks a free one, read it back from ``.port``). Returns the server."""
    return TraceServer(port, log_dir, host)
