"""The per-step record type.

Capability parity with the reference's ``RelayRLAction``
(reference: relayrl_framework/src/types/action.rs:428-525 — `{obs?, act?,
mask?, rew: f32, data?: map<String, RelayRLData>, done, reward_updated}` with
getters and `update_reward`). The aux-data union RelayRLData
(action.rs:206-218) maps onto msgpack-native scalars plus an ExtType for
tensors, so the whole record packs as one msgpack map instead of the
reference's pickle (zmq path, types/trajectory.rs:50-55) or
JSON-bytes-in-proto (grpc path, sys_utils/grpc_utils.rs:31-66).

``msgpack`` is imported inside the functions that encode or decode, so the
actor path imports on hosts that never serialize a record.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np

from relayrl_tpu_torch.types.tensor import decode_tensor, encode_tensor

# msgpack ExtType code for a wire tensor frame. Part of the wire ABI.
EXT_TENSOR = 1

AuxValue = Any  # np.ndarray | int | float | str | bool


@dataclasses.dataclass
class ActionRecord:
    """One environment step: observation, action, mask, reward, aux data.

    ``data`` carries algorithm side-channel values — the reference's REINFORCE
    stores ``logp_a`` and ``v`` there (algorithms/REINFORCE/REINFORCE.py usage
    of ``data['v']``/``data['logp_a']``) and this framework's policies do the
    same, so trajectories are self-contained for the learner.
    """

    obs: np.ndarray | None = None
    act: np.ndarray | None = None
    mask: np.ndarray | None = None
    rew: float = 0.0
    data: dict[str, AuxValue] | None = None
    done: bool = False
    reward_updated: bool = False
    # Terminated-vs-truncated distinction the reference lacks: ``done`` says
    # the episode ended; ``truncated`` says it ended by time limit, not by
    # reaching a terminal state — value targets must still bootstrap through
    # a truncation (Gymnasium step() semantics).
    truncated: bool = False

    # -- reference getter parity (action.rs:454-525) --
    def get_obs(self) -> np.ndarray | None:
        return self.obs

    def get_act(self) -> np.ndarray | None:
        return self.act

    def get_mask(self) -> np.ndarray | None:
        return self.mask

    def get_rew(self) -> float:
        return self.rew

    def get_data(self) -> dict[str, AuxValue] | None:
        return self.data

    def get_done(self) -> bool:
        return self.done

    def get_truncated(self) -> bool:
        return self.truncated

    def update_reward(self, reward: float) -> None:
        self.rew = float(reward)
        self.reward_updated = True

    # -- wire codec --
    def to_wire(self) -> dict:
        return {
            "o": _pack_opt_tensor(self.obs),
            "a": _pack_opt_tensor(self.act),
            "m": _pack_opt_tensor(self.mask),
            "r": float(self.rew),
            "d": _pack_aux(self.data),
            "t": bool(self.done),
            "u": bool(self.reward_updated),
            "x": bool(self.truncated),
        }

    @classmethod
    def from_wire(cls, wire: Mapping) -> "ActionRecord":
        return cls(
            obs=_unpack_opt_tensor(wire.get("o")),
            act=_unpack_opt_tensor(wire.get("a")),
            mask=_unpack_opt_tensor(wire.get("m")),
            rew=float(wire.get("r", 0.0)),
            data=_unpack_aux(wire.get("d")),
            done=bool(wire.get("t", False)),
            reward_updated=bool(wire.get("u", False)),
            truncated=bool(wire.get("x", False)),
        )

    def to_bytes(self) -> bytes:
        import msgpack

        return msgpack.packb(self.to_wire(), use_bin_type=True)

    @classmethod
    def from_bytes(cls, buf: bytes) -> "ActionRecord":
        import msgpack

        return cls.from_wire(
            msgpack.unpackb(buf, raw=False, ext_hook=_ext_hook, strict_map_key=False)
        )

    # -- JSON codec. Method-name parity with the reference's surface
    #    (PyRelayRLAction.to_json / action_from_json,
    #    bindings/python/o3_action.rs:29-235), NOT format parity — a
    #    deliberate departure, like the msgpack-for-pickle swap documented
    #    in trajectory.py: the reference feeds an already-parsed dict with
    #    tensors as {"inner": {shape, dtype: "Float", data}} to its learner
    #    IPC; here from_json takes the JSON *string* to_json produced, and
    #    tensors are tagged {"__tensor__": {dtype, shape, data|b64}} so
    #    numpy dtype + shape survive exactly. Human-readable debug/interop
    #    surface — the hot path stays msgpack (to_bytes). Output is strict
    #    RFC 8259 (allow_nan=False; non-finite floats are tagged), so
    #    serde_json/JSON.parse-class decoders accept it. --
    def to_jsonable(self) -> dict:
        """Plain-dict form of :meth:`to_json` (no string encode) — used by
        :meth:`Trajectory.to_json` to avoid per-action re-parsing."""
        return {
            "obs": _tensor_to_jsonable(self.obs),
            "act": _tensor_to_jsonable(self.act),
            "mask": _tensor_to_jsonable(self.mask),
            "rew": _float_to_jsonable(float(self.rew)),
            "data": (
                None
                if self.data is None
                else {k: _aux_to_jsonable(v) for k, v in self.data.items()}
            ),
            "done": bool(self.done),
            "reward_updated": bool(self.reward_updated),
            "truncated": bool(self.truncated),
        }

    @classmethod
    def from_jsonable(cls, obj: Mapping) -> "ActionRecord":
        data = obj.get("data")
        return cls(
            obs=_tensor_field_from_jsonable(obj.get("obs"), "obs"),
            act=_tensor_field_from_jsonable(obj.get("act"), "act"),
            mask=_tensor_field_from_jsonable(obj.get("mask"), "mask"),
            rew=_float_from_jsonable(obj.get("rew", 0.0)),
            data=(
                None
                if data is None
                else {k: _aux_from_jsonable(v) for k, v in data.items()}
            ),
            done=bool(obj.get("done", False)),
            reward_updated=bool(obj.get("reward_updated", False)),
            truncated=bool(obj.get("truncated", False)),
        )

    def to_json(self) -> str:
        import json

        return json.dumps(self.to_jsonable(), allow_nan=False)

    @classmethod
    def from_json(cls, text: str) -> "ActionRecord":
        import json

        return cls.from_jsonable(json.loads(text))

    # reference static-method name (o3_action.rs `action_from_json`)
    action_from_json = from_json


def _pack_opt_tensor(value) -> "msgpack.ExtType | None":
    import msgpack

    if value is None:
        return None
    return msgpack.ExtType(EXT_TENSOR, encode_tensor(value))


def _unpack_opt_tensor(value):
    import msgpack

    if value is None:
        return None
    if isinstance(value, np.ndarray):  # already decoded by ext_hook
        return value
    if isinstance(value, msgpack.ExtType):
        return decode_tensor(value.data)
    raise TypeError(f"expected tensor ext frame, got {type(value)!r}")


def _pack_aux(data: Mapping[str, AuxValue] | None):
    import msgpack

    if data is None:
        return None
    out = {}
    for key, value in data.items():
        if isinstance(value, (np.ndarray, np.generic)) and getattr(value, "shape", None) != ():
            out[key] = msgpack.ExtType(EXT_TENSOR, encode_tensor(value))
        elif isinstance(value, np.generic):
            out[key] = value.item()
        elif isinstance(value, (bool, int, float, str, bytes)):
            out[key] = value
        elif hasattr(value, "dtype") and hasattr(value, "shape"):  # array-like
            out[key] = msgpack.ExtType(EXT_TENSOR, encode_tensor(np.asarray(value)))
        else:
            raise TypeError(f"aux data {key!r} has unsupported type {type(value)!r}")
    return out


def _unpack_aux(data):
    import msgpack

    if data is None:
        return None
    out = {}
    for key, value in data.items():
        if isinstance(value, msgpack.ExtType):
            out[key] = decode_tensor(value.data)
        else:
            out[key] = value
    return out


def _ext_hook(code: int, payload: bytes):
    import msgpack

    if code == EXT_TENSOR:
        return decode_tensor(payload)
    return msgpack.ExtType(code, payload)


def _tensor_to_jsonable(value):
    """Tagged JSON form `{"__tensor__": {dtype, shape, data|b64}}` — keeps
    dtype + shape exact through a round trip (a bare nested list would
    collapse float32 -> float64 and lose empty-dim shapes). Float arrays
    holding non-finite values (e.g. -inf action-mask fills) switch the
    payload to base64 raw bytes: RFC 8259 has no NaN/Infinity literal, so
    a tolist() form would either crash allow_nan=False or emit JSON that
    serde_json/JSON.parse-class decoders reject."""
    if value is None:
        return None
    arr = np.asarray(value)
    t = {"dtype": arr.dtype.name, "shape": list(arr.shape)}
    if _has_nonfinite(arr):
        import base64

        # Fixed little-endian payload (same convention as tensor.py's
        # binary wire): dtype.name carries no endianness mark, so bytes
        # must be order-normalized on the writer, not trusted to match
        # the reader's native order.
        t["b64"] = base64.b64encode(_to_le_bytes(arr)).decode("ascii")
    else:
        t["data"] = arr.tolist()
    return {"__tensor__": t}


def _has_nonfinite(arr: np.ndarray) -> bool:
    """True when a float-like array (incl. bfloat16/float8, numpy kind
    'V') holds values JSON has no literal for (NaN/Infinity)."""
    if arr.dtype.kind not in "fV":
        return False
    try:
        return not bool(np.isfinite(arr).all())
    except TypeError:  # structured void dtypes — not float-like
        return False


def _to_le_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.kind == "f":
        le = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
        return np.ascontiguousarray(le).tobytes()
    # Custom float-likes (bfloat16/float8) have no numpy byte-order
    # variant; normalize through a little-endian unsigned view of the
    # same width.
    width = arr.dtype.itemsize
    uview = np.ascontiguousarray(arr).view(f"u{width}")
    return uview.astype(f"<u{width}", copy=False).tobytes()


def _from_le_bytes(raw: bytes, dtype: np.dtype, shape) -> np.ndarray:
    if dtype.kind == "f":
        le = np.frombuffer(raw, dtype=dtype.newbyteorder("<"))
        return le.astype(dtype, copy=True).reshape(shape)
    width = dtype.itemsize
    units = np.frombuffer(raw, dtype=f"<u{width}").astype(f"=u{width}")
    return units.view(dtype).reshape(shape).copy()


def _tensor_from_jsonable(value):
    if value is None:
        return None
    if isinstance(value, dict) and "__tensor__" in value:
        t = value["__tensor__"]
        dtype = np.dtype(t["dtype"])
        if "b64" in t:
            import base64

            return _from_le_bytes(
                base64.b64decode(t["b64"]), dtype, t["shape"])
        return np.asarray(t["data"], dtype=dtype).reshape(t["shape"])
    return value  # plain aux scalar (int/float/str/bool)


def _tensor_field_from_jsonable(value, field: str):
    """Strict decode for obs/act/mask: tensor-tagged or null only — the
    JSON twin of :func:`_unpack_opt_tensor`'s TypeError on non-tensor
    frames, so a malformed/foreign-format field fails at decode time
    instead of smuggling a plain dict into the record."""
    if value is None:
        return None
    if isinstance(value, dict) and "__tensor__" in value:
        return _tensor_from_jsonable(value)
    raise TypeError(
        f"{field!r} must be a tagged tensor object or null, "
        f"got {type(value).__name__}")


def _float_to_jsonable(x: float):
    """Non-finite floats as tagged strings (RFC 8259 has no literal)."""
    return x if np.isfinite(x) else {"__float__": repr(x)}


def _float_from_jsonable(x) -> float:
    if isinstance(x, dict) and "__float__" in x:
        return float(x["__float__"])
    return float(x)


def _aux_to_jsonable(value):
    """Mirror of :func:`_pack_aux` semantics for the JSON surface: 0-d
    numpy scalars unwrap to native Python (so both codecs decode a record
    identically), arrays and array-likes become tagged tensors, bytes become
    tagged base64, non-finite plain floats are tagged, and anything
    outside that union raises — exactly the set :func:`_pack_aux`
    accepts, so a record is JSON-encodable iff it is msgpack-encodable
    (rejecting dicts here also closes tag injection: no user value can
    collide with the ``__tensor__``/``__bytes__``/``__float__`` tags)."""
    if isinstance(value, np.generic) and getattr(value, "shape", None) == ():
        value = value.item()
    if isinstance(value, (np.ndarray, np.generic)) or (
        hasattr(value, "dtype") and hasattr(value, "shape")
    ):
        return _tensor_to_jsonable(np.asarray(value))
    if isinstance(value, bytes):
        import base64

        return {"__bytes__": base64.b64encode(value).decode("ascii")}
    if isinstance(value, float):
        return _float_to_jsonable(value)
    if isinstance(value, (bool, int, str)):
        return value
    raise TypeError(
        f"aux data has unsupported type {type(value)!r} for JSON encoding")


def _aux_from_jsonable(value):
    if isinstance(value, dict):
        if "__tensor__" in value:
            return _tensor_from_jsonable(value)
        if "__bytes__" in value:
            import base64

            return base64.b64decode(value["__bytes__"])
        if "__float__" in value:
            return _float_from_jsonable(value)
    return value
