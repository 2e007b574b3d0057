"""Build and load the port's CUDA kernels at first use.

Each source ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface, loaded with
:mod:`ctypes`. No source includes PyTorch's headers, so a build takes
seconds. Libraries go to ``build/relayrl_tpu_torch/`` at the root of the
checkout (``.gitignore`` lists ``build/``), named by a hash of the source,
the shared headers of ``csrc/`` (``*.cuh``) and the flags, so an edited
source or header builds anew; nvcc's log (``-Xptxas=-v``: registers and
spills) is kept beside each library (``.log``). ``nvcc`` is found through
``CUDA_HOME``, then ``PATH``, then ``/usr/local/cuda``.

Nothing here runs at import: the CPU tests import every module of the
port on hosts without a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "relayrl_tpu_torch"
KERNELS = ("flash_fwd", "flash_bwd", "ring_flash")
# -Xptxas=-v prints each kernel's registers, shared memory and spills
# into the build log (BUILD_LOGS).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# nvcc's output of each source built by this process.
BUILD_LOGS: dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are built "
        "from relayrl_tpu_torch/csrc at first use")


def library_path(name: str) -> Path:
    """The library of source ``name``, named by a hash of what its build
    reads: the source, every header in ``csrc/`` and the flags."""
    digest = hashlib.sha256()
    for path in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, float]:
    """Compile each source in ``names`` whose library is missing: one
    ``nvcc`` per source, all started together. Returns the seconds each
    compile took (an empty dict when everything was built already)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.monotonic())
    seconds, failures = {}, []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        seconds[name] = time.monotonic() - t0
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failures.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failures:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build((name,))
            lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return lib

