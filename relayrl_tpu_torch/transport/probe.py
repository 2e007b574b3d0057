"""Wire-protocol probing: identify what a live server endpoint speaks.

The three transports are mutually unintelligible on the wire — ZMTP
framing (zmq), HTTP/2 (grpc), and the native length-prefixed frames — so
a fleet whose two ends resolve different ``server_type`` values used to
fail only as a remote handshake timeout with no breadcrumb (``auto``
once resolved PER PROCESS from local .so availability).

``probe_endpoint`` classifies a TCP endpoint by what the protocols
volunteer or answer:

* **zmq** — libzmq sends its 10-byte ZMTP greeting (``FF …signature… 7F``)
  immediately on accept, before the client says anything. The probe
  listens PASSIVELY first: sending non-ZMTP bytes to a libzmq socket is
  a protocol error that makes it throttle greetings to subsequent raw
  connections (observed empirically), which would poison later probes.
* **native** — the C++ core answers a Ping frame with a Pong frame
  (native/transport.cc kFramePing/kFramePong); it never speaks first, so
  the Ping goes out only after the passive window stays silent.
* **grpc** — an HTTP/2 server answers the client connection preface +
  empty SETTINGS with its own SETTINGS frame (RFC 7540 §3.5); it drops
  the ping bytes silently, so this takes a second connection.

A ZMTP greeting or native Pong is honored at ANY stage (slow servers may
answer late, even into the gRPC pass). ``make_agent_transport`` uses
this to negotiate ``auto`` against the live server and to fail fast on
explicit mismatches instead of timing out.

A copy of :mod:`relayrl_tpu.transport.probe`.
"""

from __future__ import annotations

import socket
import struct
import time

# native frame layout (native/transport.cc): u32 len | u8 type
_NATIVE_PING = struct.pack("<IB", 0, 8)
_NATIVE_PONG = struct.pack("<IB", 0, 9)
# RFC 7540 §3.5 client preface, followed by an empty SETTINGS frame.
_H2_PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n" + b"\x00\x00\x00\x04\x00\x00\x00\x00\x00"
_H2_SETTINGS_TYPE = 0x04


class ProtocolMismatchError(RuntimeError):
    """Raised when a probed server speaks a different transport protocol
    than the one this process was configured with."""


def _connect(host: str, port: int, timeout_s: float) -> socket.socket | None:
    try:
        return socket.create_connection((host, port), timeout=timeout_s)
    except OSError:
        return None


def _classify_frame(buf: bytes) -> str | None:
    if len(buf) >= 10 and buf[0] == 0xFF and buf[9] == 0x7F:
        return "zmq"
    if buf.startswith(_NATIVE_PONG):
        return "native"
    if len(buf) >= 9 and buf[3:4] == bytes([_H2_SETTINGS_TYPE]):
        return "grpc"
    return None


def probe_endpoint(host: str, port: int, timeout_s: float = 1.0) -> str:
    """Classify the protocol spoken at ``host:port``.

    Returns one of ``"zmq" | "native" | "grpc" | "unknown" | "unreachable"``.
    ``unknown`` (something answered, but not one of ours) and
    ``unreachable`` (nothing listening) are deliberately non-committal —
    callers must not hard-fail on them, since a server may simply not be
    up yet.
    """
    deadline = time.monotonic() + timeout_s
    # Pass 1: passive listen (zmq speaks first), then a native Ping on the
    # same connection if the server stayed silent.
    sock = _connect(host, port, timeout_s)
    if sock is None:
        return "unreachable"
    try:
        buf = b""
        pinged = False
        # Scale the passive window with the caller's budget: pinging a
        # loaded zmq server that just hasn't greeted yet makes libzmq
        # throttle greetings to later raw connections (see module header),
        # so spend up to 60% of the timeout (capped 0.5s) listening first.
        passive_until = time.monotonic() + min(0.5, timeout_s * 0.6)
        while time.monotonic() < deadline:
            verdict = _classify_frame(buf)
            if verdict:
                return verdict
            if not pinged and not buf and time.monotonic() >= passive_until:
                # Silent server: not zmq. Ask the native core for a Pong.
                try:
                    sock.sendall(_NATIVE_PING)
                except OSError:
                    break
                pinged = True
            sock.settimeout(0.05)
            try:
                chunk = sock.recv(4096)
            except socket.timeout:
                continue
            except (ConnectionError, OSError):
                break
            if not chunk:
                break  # peer closed on us (h2 rejecting ping bytes, etc.)
            buf += chunk
        verdict = _classify_frame(buf)
        if verdict:
            return verdict
        if not pinged:
            return "unknown"  # endpoint spoke, but nothing we recognize
    finally:
        sock.close()
    # Pass 2: fresh connection for the HTTP/2 preface (an h2 server drops
    # the ping-bytes connection above without answering).
    sock = _connect(host, port, max(0.1, deadline - time.monotonic()))
    if sock is None:
        return "unreachable"
    try:
        try:
            sock.sendall(_H2_PREFACE)
        except OSError:
            return "unknown"
        buf = b""
        h2_deadline = max(time.monotonic() + 0.2, deadline)
        while time.monotonic() < h2_deadline:
            verdict = _classify_frame(buf)
            if verdict:
                return verdict
            sock.settimeout(max(0.05, h2_deadline - time.monotonic()))
            try:
                chunk = sock.recv(4096)
            except (socket.timeout, ConnectionError, OSError):
                break
            if not chunk:
                break
            buf += chunk
        return _classify_frame(buf) or "unknown"
    finally:
        sock.close()


def parse_host_port(addr: str) -> tuple[str, int]:
    """``tcp://h:p`` / ``h:p`` -> (h, p)."""
    addr = addr.split("//")[-1]
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)
