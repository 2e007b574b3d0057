"""Native C++ transport backend (ctypes bindings over the port's build of
``native/``).

Counterpart of :mod:`relayrl_tpu.transport.native_backend`. The C++ core
under ``native/`` is a framed-TCP epoll event loop speaking the same
envelopes as the Python backends, plus an HTTP/2 gRPC server. The port
compiles it from source at first use (:mod:`relayrl_tpu_torch._native`,
into ``build/relayrl_tpu_torch/``); this module is the thin entry to the
bindings in :mod:`~relayrl_tpu_torch.transport.native_bindings`.
"""

from __future__ import annotations


def native_available() -> bool:
    """Whether the native library builds (or is built) and so loads."""
    from relayrl_tpu_torch._native import find_library

    return find_library() is not None


def _require_lib() -> str:
    from relayrl_tpu_torch._native import build

    try:
        return str(build())
    except RuntimeError as e:
        raise RuntimeError(
            f"the port's native transport library could not be built "
            f"from native/*.cc into build/relayrl_tpu_torch/ ({e}); use "
            f"server_type='zmq' or 'grpc' instead") from None


# The implementations live in native_bindings, imported lazily so zmq and
# grpc users never touch ctypes.
def NativeServerTransport(*args, **kwargs):
    from relayrl_tpu_torch.transport.native_bindings import (
        NativeServerTransportImpl,
    )

    return NativeServerTransportImpl(_require_lib(), *args, **kwargs)


def NativeGrpcServerTransport(*args, **kwargs):
    from relayrl_tpu_torch.transport.native_bindings import (
        NativeGrpcServerTransportImpl,
    )

    return NativeGrpcServerTransportImpl(_require_lib(), *args, **kwargs)


def NativeAgentTransport(*args, **kwargs):
    from relayrl_tpu_torch.transport.native_bindings import (
        NativeAgentTransportImpl,
    )

    return NativeAgentTransportImpl(_require_lib(), *args, **kwargs)
