"""Build the native C++ transport and codec library at first use.

``native/`` holds the C++ shared by both packages' wire: the framed-TCP
transport core (``transport.cc``), the msgpack → columnar codec
(``codec.cc``) and the HTTP/2 gRPC server (``grpc_server.cc``, with
``event_hub.h``). The port compiles the unchanged sources with the flags
of ``native/Makefile`` into ``build/relayrl_tpu_torch/`` at the root of
the checkout (``.gitignore`` lists ``build/``), named by a hash of the
sources and the flags, as :mod:`relayrl_tpu_torch._kernels` builds
``csrc/``: one compile per source, all started together, then one link.
It never runs ``make`` and never writes into ``native/``.

Nothing here runs at import: the library is built and loaded when a
native transport or a :class:`~relayrl_tpu_torch.types.columnar.
NativeDecoder` is first built.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from relayrl_tpu_torch._kernels import BUILD_DIR, _lock

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
SOURCES = ("transport.cc", "codec.cc", "grpc_server.cc")
HEADERS = ("event_hub.h",)
# native/Makefile's CXXFLAGS, for each compile and the link (which adds
# -shared). -Wall -Wextra stay: g++ warns -Wstringop-overflow at
# transport.cc:71, which is no error here.
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread")

# The build's outcome in this process: a path, or the reason it failed.
_built: dict[str, object] = {}


def library_path() -> Path:
    """The library's path, named by a hash of every source, the header
    and the flags."""
    digest = hashlib.sha256()
    for name in (*SOURCES, *HEADERS):
        digest.update(name.encode() + b"\0" + (NATIVE_DIR / name).read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"librelayrl_native-{digest.hexdigest()[:16]}.so"


def _cxx() -> str | None:
    return os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")


def build() -> Path:
    """Compile the library unless it exists; returns its path. Raises
    RuntimeError when there is no compiler or the compile fails. Another
    process may build at the same time: each writes a name of its own and
    moves it into place atomically."""
    with _lock:
        if "path" in _built:
            return _built["path"]
        if "error" in _built:
            raise RuntimeError(_built["error"])
        try:
            out = library_path()
        except OSError as e:
            _built["error"] = f"native sources unreadable: {e!r}"
            raise RuntimeError(_built["error"]) from None
        if not out.exists():
            cxx = _cxx()
            if cxx is None:
                _built["error"] = ("no C++ compiler (g++) found to build the "
                                   "native library from native/*.cc")
                raise RuntimeError(_built["error"])
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tag = f"{out.stem}.{os.getpid()}"
            objs = [BUILD_DIR / f"{tag}.{name}.o" for name in SOURCES]
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            try:
                procs = [subprocess.Popen(
                    [cxx, *CXX_FLAGS, "-c", "-o", str(obj),
                     str(NATIVE_DIR / name)], stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)
                    for name, obj in zip(SOURCES, objs)]
                logs = [proc.communicate(timeout=600)[0] for proc in procs]
                failed = [(name, proc.returncode, log) for name, proc, log
                          in zip(SOURCES, procs, logs) if proc.returncode]
                if not failed:
                    link = subprocess.run(
                        [cxx, *CXX_FLAGS, "-shared", "-o", str(tmp),
                         *map(str, objs)], capture_output=True, text=True,
                        timeout=600)
                    logs.append(link.stderr)
                    if link.returncode:
                        failed.append(("link", link.returncode, link.stderr))
            finally:
                for obj in objs:
                    obj.unlink(missing_ok=True)
            if failed:
                tmp.unlink(missing_ok=True)
                _built["error"] = "native library build failed: " + "\n".join(
                    f"{name} (exit {rc}):\n{log}" for name, rc, log in failed)
                raise RuntimeError(_built["error"])
            out.with_suffix(".log").write_text("".join(logs))
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        _built["path"] = out
        return out


def find_library() -> str | None:
    """The built library's path, building it first; None when it cannot
    be built here."""
    try:
        return str(build())
    except RuntimeError:
        return None
