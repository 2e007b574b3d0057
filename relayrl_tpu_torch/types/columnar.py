"""Columnar decoded trajectories: the RLD1 frames and their pure-Python
decode.

Counterpart of :mod:`relayrl_tpu.types.columnar`. A
:class:`DecodedTrajectory` holds one wire trajectory as columns (a
handful of ``np.frombuffer`` views, no per-step objects), terminal
markers folded; ``n_steps`` counts real steps and ``final_obs`` /
``final_mask`` / ``marker_truncated`` carry what the markers contributed.
:func:`encode_columnar_frame` and :func:`parse_frame` are the columnar
wire (an RLD1 kind-0 blob with a CRC footer), byte for byte the JAX
package's. :class:`NativeDecoder` wraps ``rl_decode`` of the port's
build of ``native/codec.cc`` (:mod:`relayrl_tpu_torch._native`): it parses
a msgpack wire trajectory off the GIL into one RLD1 blob, terminal markers
folded with the semantics of
:func:`relayrl_tpu_torch.data.batching.fold_trailing_markers`, so the
ZMQ/gRPC ingest reuses the native decoder even though their sockets live
in Python. Without the library the server decodes in Python.
"""

from __future__ import annotations

import ctypes
import dataclasses
import struct
import threading
import zlib

import numpy as np

from relayrl_tpu_torch.types.action import ActionRecord
from relayrl_tpu_torch.types.dtypes import DType, from_numpy_dtype, to_numpy_dtype
from relayrl_tpu_torch.types.tensor import decode_tensor, encode_tensor

_BLOB_MAGIC = 0x31444C52  # "RLD1"
MAGIC_BYTES = b"RLD1"  # little-endian prefix of every blob/frame
KIND_COLUMNAR = 0
KIND_RAW = 1
KIND_REGISTER = 2
KIND_RAW_ENVELOPE = 3
KIND_UNREGISTER = 4

# -- columnar WIRE frames (the trajectory fast path) --
#
# A columnar frame is an RLD1 kind-0 blob shipped AS the trajectory
# payload (inside the usual transport envelope, so attribution and the
# spool's ``#s<seq>`` tag ride the envelope id unchanged), extended with
# a footer the wire needs but the in-process drain does not:
#
#     flags bit 3 (8): u8 frame_version | u32 crc32
#
# The CRC covers every preceding byte of the blob (header through the
# final-tensor sections), so a corrupt frame is detected at decode time
# instead of poisoning the staging slabs. The native C++ codec never
# emits the footer bit, so its drain blobs parse exactly as before; a
# frame arriving over the native transport rides the C++ envelope
# decoder's raw-fallback path verbatim (codec.cc carries unknown
# payloads through untouched) and is parsed HERE, so one Python parser
# serves all three transports.
FRAME_VERSION = 1
FLAG_MARKER_TRUNCATED = 1
FLAG_FINAL_OBS = 2
FLAG_FINAL_MASK = 4
FLAG_FOOTER = 8
_FOOTER = struct.Struct("<BI")  # frame_version, crc32


def is_columnar_frame(payload) -> bool:
    """Cheap wire sniff: does this trajectory payload carry an RLD1
    columnar frame (vs a msgpack per-record trajectory, which always
    starts with a msgpack map byte)?"""
    return len(payload) >= _HDR.size and bytes(payload[:4]) == MAGIC_BYTES


@dataclasses.dataclass
class DecodedTrajectory:
    """One wire trajectory as columns (markers folded)."""

    agent_id: str
    n_steps: int
    n_records: int  # pre-fold record count — bucketing parity with the
    #                 ActionRecord path (pick_bucket sees raw record count)
    marker_truncated: bool
    columns: dict[str, np.ndarray]  # "o","a","m","r","t","u","x" (present ones)
    aux: dict[str, np.ndarray]      # per-step aux columns ("v","logp_a",...)
    final_obs: np.ndarray | None = None
    final_mask: np.ndarray | None = None

    def __len__(self) -> int:
        return self.n_records

    @property
    def total_reward(self) -> float:
        r = self.columns.get("r")
        return float(r.sum()) if r is not None else 0.0

    def to_action_records(self) -> list[ActionRecord]:
        """Reconstruct per-step records (compat path for consumers without
        a columnar fast path). Marker contributions that survive folding
        (bootstrap obs/mask, truncation flag) are re-attached as one
        synthetic trailing marker so downstream re-folding reproduces the
        same result."""
        cols, aux = self.columns, self.aux
        records = []
        for t in range(self.n_steps):
            data = {k: v[t] for k, v in aux.items()} or None
            records.append(ActionRecord(
                obs=cols["o"][t] if "o" in cols else None,
                act=cols["a"][t] if "a" in cols else None,
                mask=cols["m"][t] if "m" in cols else None,
                rew=float(cols["r"][t]),
                data=data,
                done=bool(cols["t"][t]),
                reward_updated=bool(cols["u"][t]),
                truncated=bool(cols["x"][t]),
            ))
        if (self.final_obs is not None or self.final_mask is not None
                or self.marker_truncated):
            records.append(ActionRecord(
                obs=self.final_obs, act=None, mask=self.final_mask,
                rew=0.0, done=False, truncated=self.marker_truncated))
        return records


def _all_finite(value) -> bool:
    """False iff the value holds NaN/inf. Delegates to action.py's
    _has_nonfinite, whose kind check covers 'V' — bfloat16/float8 arrive
    via ml_dtypes with dtype.kind 'V', and a kind-'f'-only check would
    wave their NaNs straight through the guard."""
    from relayrl_tpu_torch.types.action import _has_nonfinite

    try:
        return not _has_nonfinite(np.asarray(value))
    except Exception:
        # Unconvertible aux values can't reach a batch column either
        # (np.asarray fails identically there, isolated by the server's
        # per-trajectory exception handling) — treat as inert here.
        return True


def trajectory_is_finite(item) -> bool:
    """True iff every training-relevant float in the trajectory is finite.

    The ingest trust boundary's semantic guard: a NaN/inf smuggled into
    obs, act, reward, or a float aux column (v, logp_a feed REINFORCE/
    IMPALA losses directly) would not crash anything — it would silently
    poison the learner state and, through the next publish, the whole
    fleet. Both algorithm families call this in ``accumulate`` and drop
    the trajectory (counted, logged) when it fails. Action masks are
    deliberately NOT checked: models consume them as ``mask > 0``, so a
    -inf fill is semantically harmless.

    Accepts either wire representation: a :class:`DecodedTrajectory`
    (columnar fast path) or a list of :class:`ActionRecord`.
    """
    if isinstance(item, DecodedTrajectory):
        for key in ("o", "a", "r"):
            col = item.columns.get(key)
            if col is not None and not _all_finite(col):
                return False
        for col in item.aux.values():
            if not _all_finite(col):
                return False
        if item.final_obs is not None and not _all_finite(item.final_obs):
            return False
        return True
    for a in item:
        if not np.isfinite(a.rew):
            return False
        for value in (a.obs, a.act):
            if value is not None and not _all_finite(value):
                return False
        for v in (a.data or {}).values():
            # Skip only known-inert types: a NaN can arrive as a plain
            # msgpack list (foreign encoder) or an ml_dtypes scalar, and
            # both feed batch columns via np.asarray downstream.
            if isinstance(v, (str, bytes, bool)):
                continue
            if not _all_finite(v):
                return False
    return True


@dataclasses.dataclass
class RawTrajectory:
    """Fallback: the native decoder couldn't columnarize this payload;
    carry the original bytes for the Python decoder. ``is_envelope`` marks
    payloads that are still wrapped in the transport envelope (the
    envelope itself failed to parse natively, or the decoder threw) —
    consumers must ``unpack_trajectory_envelope`` first."""

    agent_id: str
    payload: bytes
    is_envelope: bool = False


@dataclasses.dataclass
class Registration:
    agent_id: str


@dataclasses.dataclass
class Unregistration:
    """A registered agent's control connection died (crash / kill -9 /
    idle-reap): elastic-fleet registry maintenance."""

    agent_id: str


_HDR = struct.Struct("<IBI")          # magic, kind, id_len
_COL_FIXED = struct.Struct("<BB")     # dtype, ndim (after name)
_META = struct.Struct("<IIBH")        # n_steps, n_records, flags, n_cols


def parse_blob(view: memoryview, off: int = 0, verify_crc: bool = True):
    """Parse one RLD1 blob at ``off``; returns ``(item, next_off)``.

    Blobs carrying the wire footer (``flags & FLAG_FOOTER``, produced by
    :func:`encode_columnar_frame`) are CRC-verified here — a mismatch
    raises ``ValueError`` so the ingest path counts the frame as
    malformed instead of staging corrupt columns. ``verify_crc=False``
    skips the recompute for callers that already checked the footer
    (:func:`parse_frame` verifies integrity BEFORE parsing)."""
    start = off
    magic, kind, id_len = _HDR.unpack_from(view, off)
    if magic != _BLOB_MAGIC:
        raise ValueError(f"bad RLD1 magic {magic:#x}")
    off += _HDR.size
    agent_id = bytes(view[off:off + id_len]).decode(errors="replace")
    off += id_len
    if kind == KIND_REGISTER:
        return Registration(agent_id), off
    if kind == KIND_UNREGISTER:
        return Unregistration(agent_id), off
    if kind in (KIND_RAW, KIND_RAW_ENVELOPE):
        (n,) = struct.unpack_from("<Q", view, off)
        off += 8
        payload = bytes(view[off:off + n])
        return RawTrajectory(agent_id, payload,
                             is_envelope=(kind == KIND_RAW_ENVELOPE)), off + n
    n_steps, n_records, flags, n_cols = _META.unpack_from(view, off)
    off += _META.size
    descs = []
    for _ in range(n_cols):
        name_len = view[off]
        off += 1
        name = bytes(view[off:off + name_len]).decode()
        off += name_len
        dtype_tag, ndim = _COL_FIXED.unpack_from(view, off)
        off += _COL_FIXED.size
        dims = struct.unpack_from(f"<{ndim}I", view, off)
        off += 4 * ndim
        col_off, nbytes = struct.unpack_from("<QQ", view, off)
        off += 16
        descs.append((name, dtype_tag, dims, col_off, nbytes))
    (data_len,) = struct.unpack_from("<Q", view, off)
    off += 8
    data = view[off:off + data_len]
    off += data_len
    columns: dict[str, np.ndarray] = {}
    aux: dict[str, np.ndarray] = {}
    for name, dtype_tag, dims, col_off, nbytes in descs:
        np_dtype = to_numpy_dtype(DType(dtype_tag))
        arr = np.frombuffer(data[col_off:col_off + nbytes],
                            dtype=np_dtype).reshape(dims)
        if name.startswith("d:"):
            aux[name[2:]] = arr
        else:
            columns[name] = arr
    final_obs = final_mask = None
    if flags & 2:
        (n,) = struct.unpack_from("<I", view, off)
        off += 4
        final_obs = decode_tensor(view[off:off + n])
        off += n
    if flags & 4:
        (n,) = struct.unpack_from("<I", view, off)
        off += 4
        final_mask = decode_tensor(view[off:off + n])
        off += n
    if flags & FLAG_FOOTER:
        version, crc = _FOOTER.unpack_from(view, off)
        if version != FRAME_VERSION:
            raise ValueError(
                f"unsupported columnar frame version: {version}")
        if (verify_crc
                and zlib.crc32(view[start:off]) & 0xFFFFFFFF != crc):
            raise ValueError("columnar frame CRC mismatch")
        off += _FOOTER.size
    return DecodedTrajectory(
        agent_id=agent_id, n_steps=n_steps, n_records=n_records,
        marker_truncated=bool(flags & 1), columns=columns, aux=aux,
        final_obs=final_obs, final_mask=final_mask), off


def parse_drain(buf: memoryview | bytes) -> list:
    """Parse a batch-drain buffer: u64-length-prefixed RLD1 blobs."""
    view = memoryview(buf)
    items = []
    off = 0
    while off < len(view):
        (blob_len,) = struct.unpack_from("<Q", view, off)
        off += 8
        item, end = parse_blob(view, off)
        if end - off != blob_len:
            raise ValueError(
                f"blob framing mismatch: prefix {blob_len}, parsed {end - off}")
        items.append(item)
        off = end
    return items


# -- columnar frame encode/decode (the trajectory wire fast path) --

_CANONICAL_COLS = ("o", "a", "m", "r", "t", "u", "x")


# dtype-tag memo keyed by the dtype object: the emitter encodes tens of
# thousands of small frames per second, and from_numpy_dtype's
# np.dtype() + dict hop per column was measurable at that rate.
_TAG_BY_DTYPE: dict = {}


def _dtype_tag(dtype) -> int:
    tag = _TAG_BY_DTYPE.get(dtype)
    if tag is None:
        tag = int(from_numpy_dtype(dtype))
        _TAG_BY_DTYPE[dtype] = tag
    return tag


def encode_columnar_frame(dt: DecodedTrajectory,
                          agent_id: str | None = None) -> bytes:
    """One :class:`DecodedTrajectory` → wire frame bytes.

    The layout is the RLD1 kind-0 blob the native drain already emits
    (so :func:`parse_blob` is the one parser for both), plus the CRC
    footer (``FLAG_FOOTER``). Attribution normally rides the transport
    envelope — ``agent_id`` defaults to the trajectory's own id and may
    be empty to save wire bytes when the envelope carries it."""
    ident = (dt.agent_id if agent_id is None else agent_id).encode()
    flags = FLAG_FOOTER
    if dt.marker_truncated:
        flags |= FLAG_MARKER_TRUNCATED
    if dt.final_obs is not None:
        flags |= FLAG_FINAL_OBS
    if dt.final_mask is not None:
        flags |= FLAG_FINAL_MASK
    names = [n for n in _CANONICAL_COLS if n in dt.columns]
    names += [n for n in dt.columns if n not in _CANONICAL_COLS]
    cols = [(name.encode(), dt.columns[name]) for name in names]
    cols += [(b"d:" + name.encode(), arr) for name, arr in dt.aux.items()]
    out = bytearray(_HDR.pack(_BLOB_MAGIC, KIND_COLUMNAR, len(ident)))
    out += ident
    out += _META.pack(dt.n_steps, dt.n_records, flags, len(cols))
    pack = struct.pack
    off = 0
    payloads = []
    for name, arr in cols:
        if not arr.flags.c_contiguous:
            arr = np.ascontiguousarray(arr)
        nbytes = arr.nbytes
        # one pack per column: name_len|name|dtype|ndim|dims|off|nbytes
        out += pack(f"<B{len(name)}sBB{arr.ndim}IQQ", len(name), name,
                    _dtype_tag(arr.dtype), arr.ndim, *arr.shape,
                    off, nbytes)
        padded = (nbytes + 7) & ~7  # 8-align each column
        payloads.append((arr, padded - nbytes))
        off += padded
    out += pack("<Q", off)
    for arr, pad in payloads:
        out += arr.tobytes()
        if pad:
            out += b"\x00" * pad
    for final in (dt.final_obs, dt.final_mask):
        if final is not None:
            frame = encode_tensor(final)
            out += pack("<I", len(frame))
            out += frame
    out += _FOOTER.pack(FRAME_VERSION, zlib.crc32(out) & 0xFFFFFFFF)
    return bytes(out)


def parse_frame(payload, agent_id: str | None = None) -> DecodedTrajectory:
    """Wire frame bytes → :class:`DecodedTrajectory` (CRC verified).

    The strict wire-side entry point: exactly one CRC-footed columnar
    blob, nothing trailing. ``agent_id`` (the transport envelope's
    attribution, seq tag already stripped by the caller) overrides the
    frame-embedded id when given — the envelope owns attribution on
    every transport, mirroring the msgpack decode path."""
    view = memoryview(payload)
    try:
        _, kind, id_len = _HDR.unpack_from(view, 0)
        if kind != KIND_COLUMNAR:
            raise ValueError(
                f"payload is an RLD1 blob but not a columnar frame "
                f"(kind {kind})")
        if not view[_HDR.size + id_len + 8] & FLAG_FOOTER:
            # Wire frames are always CRC-footed (encode_columnar_frame);
            # an unfooted kind-0 blob on the wire is foreign/corrupt.
            raise ValueError("columnar wire frame missing CRC footer")
        # Integrity FIRST: the footer sits in the last 5 bytes, so the
        # whole frame is checksummed before any column is trusted — a
        # corrupt frame fails here with the CRC verdict, never as a
        # numpy shape error halfway through a poisoned parse.
        version, crc = _FOOTER.unpack_from(view, len(view) - _FOOTER.size)
        if version != FRAME_VERSION:
            raise ValueError(
                f"unsupported columnar frame version: {version}")
        if zlib.crc32(view[:len(view) - _FOOTER.size]) & 0xFFFFFFFF != crc:
            raise ValueError("columnar frame CRC mismatch")
        # verify_crc=False: the full-frame checksum above already covered
        # every byte parse_blob will walk — no second pass on the ingest
        # hot path.
        item, end = parse_blob(view, verify_crc=False)
    except (struct.error, IndexError) as e:
        # Truncated/hostile frames surface as data-shaped errors, the
        # class transport receive loops classify as droppable.
        raise ValueError(f"malformed columnar frame: {e}") from e
    if end != len(view):
        raise ValueError(
            f"columnar frame framing mismatch: {len(view) - end} "
            f"trailing bytes")
    if agent_id is not None:
        item.agent_id = agent_id
    return item


# -- ctypes wrapper over rl_decode (shared with the zmq/grpc ingest path) --

_codec_lock = threading.Lock()
_codec_lib = None
_codec_checked = False


def _load_codec():
    global _codec_lib, _codec_checked
    with _codec_lock:
        if _codec_checked:
            return _codec_lib
        _codec_checked = True
        from relayrl_tpu_torch._native import find_library

        # torchlint: disable=LOCK02 - one load per process: a decoder that arrives during the first build needs its library too, so it waits rather than race a second build
        path = find_library()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
            lib.rl_decode.restype = ctypes.c_long
            lib.rl_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
                ctypes.c_int, ctypes.c_char_p, ctypes.c_size_t]
        except (OSError, AttributeError):
            return None
        _codec_lib = lib
        return _codec_lib


def native_codec_available() -> bool:
    return _load_codec() is not None


class NativeDecoder:
    """Per-thread reusable decode buffer around ``rl_decode``.

    The ctypes call releases the GIL for the whole msgpack parse + column
    build, so a staging thread decodes while the learner thread runs the
    device step.
    """

    def __init__(self, initial_cap: int = 1 << 20):
        self._lib = _load_codec()
        if self._lib is None:
            raise RuntimeError("native codec library unavailable")
        self._cap = initial_cap
        self._buf = ctypes.create_string_buffer(self._cap)

    def decode(self, payload: bytes, agent_id: str = "?",
               has_envelope: bool = False):
        """Payload (or envelope) bytes -> DecodedTrajectory | RawTrajectory."""
        while True:
            n = self._lib.rl_decode(payload, len(payload),
                                    agent_id.encode(), int(has_envelope),
                                    self._buf, self._cap)
            if n < 0:
                return RawTrajectory(agent_id, payload)
            if n <= self._cap:
                # Slice-copy out of the reusable buffer: the parsed columns
                # are zero-copy views and must not alias the next decode.
                item, _ = parse_blob(memoryview(self._buf[:n]))
                return item
            self._cap = int(n) * 2
            self._buf = ctypes.create_string_buffer(self._cap)
