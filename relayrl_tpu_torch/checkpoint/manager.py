"""Checkpoint/resume of the full learner state, torch-native.

Counterpart of :mod:`relayrl_tpu.checkpoint.manager` (an orbax manager
there). A checkpoint is the complete train state: the params, every
optimizer's state (Adam's moments and step counts), the RNG state, the
model version and the epoch counter, plus JSON extras. Layout::

    <directory>/<step>/state.pt     torch.save of the state, tensors on the CPU
    <directory>/<step>/extra.json   epoch, version, arch, health tag, ...
    <directory>/<step>/aux.pt       optional host arrays (replay buffers)

A step is written into ``<step>.tmp-<pid>`` and renamed into place with
``os.replace``, so a SIGKILL mid-save leaves at most a stray ``.tmp``
directory (ignored and swept) and the last whole checkpoint untouched.
Saves are synchronous; ``wait`` is accepted for the JAX package's
signature. A restore moves every tensor onto the device the algorithm
lives on.

In a multi-process learner (:mod:`relayrl_tpu_torch.parallel.distributed`)
:func:`checkpoint_algorithm` is collective: the coordinator writes the
whole state to the shared directory, and every process waits at a
barrier until the step is in place. Where a split of the state crosses
processes (fsdp, ep or tp across them), each process holds only its
shards, and where pp does, only its pipeline stages' layers and moments:
every process then captures the state, its split parameters and moments
gathered whole from every rank (a stage's from its owner), before the
coordinator writes. A resume restores the same step on every process,
each keeping its own shards and stages. Checkpoints stay mesh-free.
"""

from __future__ import annotations

import dataclasses
import json
import os
import os.path as osp
import shutil
from typing import Any

import torch


class StepAlreadyExistsError(ValueError):
    """A save at a step number that is already on disk (orbax's name)."""


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def capture_state(state) -> dict:
    """A train-state dataclass -> a picklable dict of host values: a
    module becomes its state dict, an optimizer its state dict (step
    counts included), anything else is kept as is. A state placed on a
    mesh is captured whole (its split parameters and their moments
    gathered), so a checkpoint does not depend on the mesh."""
    from relayrl_tpu_torch.parallel.learner import whole_optimizer_state
    from relayrl_tpu_torch.weights import logical_state

    out = {}
    for field in dataclasses.fields(state):
        value = getattr(state, field.name)
        if isinstance(value, torch.nn.Module):
            value = logical_state(value)
        elif isinstance(value, torch.optim.Optimizer):
            value = whole_optimizer_state(value)
        out[field.name] = _to_cpu(value)
    return out


def apply_state(state, saved: dict):
    """Load :func:`capture_state`'s dict back into the live train state:
    modules and optimizers in place (their tensors stay on the device
    they live on; a placed state's shards take their slices), other
    fields replaced."""
    from relayrl_tpu_torch.parallel.learner import load_whole_optimizer_state
    from relayrl_tpu_torch.weights import load_logical

    plain = {}
    for field in dataclasses.fields(state):
        value = getattr(state, field.name)
        if field.name not in saved:
            raise KeyError(f"checkpoint has no state field {field.name!r}")
        if isinstance(value, torch.nn.Module):
            load_logical(value, saved[field.name])
        elif isinstance(value, torch.optim.Optimizer):
            load_whole_optimizer_state(value, saved[field.name])
        else:
            plain[field.name] = saved[field.name]
    return dataclasses.replace(state, **plain)


def train_state_digest(saved: dict) -> dict:
    """Fingerprint of a :func:`capture_state` dict: ``{"params": sha256
    over the params' state-dict bytes in key order, "adam_steps": every
    optimizer's per-parameter step counts}`` — equal fingerprints mean
    bit-equal params and the same Adam position."""
    import hashlib

    h = hashlib.sha256()
    params = saved.get("params") or {}
    for key, tensor in params.items():
        h.update(key.encode())
        h.update(tensor.detach().cpu().contiguous().reshape(-1)
                 .view(torch.uint8).numpy().tobytes())
    steps = {}
    for name, value in saved.items():
        if isinstance(value, dict) and "state" in value \
                and "param_groups" in value:
            steps[name] = sorted({float(s["step"]) for s in
                                  value["state"].values() if "step" in s})
    return {"params": h.hexdigest(), "adam_steps": steps}


def _rng_state() -> dict:
    rng = {"cpu": torch.get_rng_state()}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        rng["cuda"] = torch.cuda.get_rng_state_all()
    return rng


def _set_rng_state(rng: dict) -> None:
    if "cpu" in rng:
        torch.set_rng_state(rng["cpu"])
    if "cuda" in rng and torch.cuda.is_available():
        torch.cuda.set_rng_state_all(rng["cuda"])


class CheckpointManager:
    """Numbered step directories + latest-step resume."""

    DEFAULT_MAX_TO_KEEP = 3

    def __init__(self, directory: str,
                 max_to_keep: int = DEFAULT_MAX_TO_KEEP):
        self.directory = osp.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return osp.join(self.directory, str(int(step)))

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and osp.isfile(
                    osp.join(self.directory, name, "state.pt")):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, extra: dict | None = None,
             wait: bool = False, aux: Any = None,
             overwrite: bool = False) -> int:
        """Write one step; returns the step number written.
        ``overwrite=True`` makes a same-step collision land at the next
        free step number (never deleting the existing one); without it a
        collision raises :class:`StepAlreadyExistsError`."""
        existing = self.all_steps()
        if step in existing:
            if not overwrite:
                raise StepAlreadyExistsError(
                    f"checkpoint step {step} already exists in "
                    f"{self.directory}")
            step = max(existing) + 1
        tmp = osp.join(self.directory, f"{int(step)}.tmp-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, osp.join(tmp, "state.pt"))
        with open(osp.join(tmp, "extra.json"), "w") as f:
            json.dump(extra if extra is not None else {}, f)
        if aux is not None:
            torch.save(aux, osp.join(tmp, "aux.pt"))
        os.replace(tmp, self._step_dir(step))
        self._prune()
        return int(step)

    def _prune(self) -> None:
        for name in os.listdir(self.directory):
            if ".tmp-" in name:  # a save cut short (crash mid-write)
                shutil.rmtree(osp.join(self.directory, name),
                              ignore_errors=True)
        steps = self.all_steps()
        for stale in steps[:-self.max_to_keep] if self.max_to_keep else []:
            shutil.rmtree(self._step_dir(stale), ignore_errors=True)

    def restore(self, step: int | None = None, load_aux: bool = True,
                map_location="cpu") -> tuple[Any, dict, Any]:
        """``(state, extra, aux)`` at ``step`` (default latest). ``aux``
        falls back to the newest older step that carries one."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = self._step_dir(step)
        state = torch.load(osp.join(path, "state.pt"),
                           map_location=map_location, weights_only=False)
        extra = self.read_extra(step)
        aux = None
        if load_aux:
            for s in [step] + [s for s in reversed(self.all_steps())
                               if s < step]:
                aux_path = osp.join(self._step_dir(s), "aux.pt")
                if osp.isfile(aux_path):
                    aux = torch.load(aux_path, weights_only=False)
                    break
        return state, extra, aux

    def read_extra(self, step: int) -> dict:
        """The JSON extras of one step, without touching the arrays."""
        with open(osp.join(self._step_dir(step), "extra.json")) as f:
            return dict(json.load(f))

    def healthy_steps(self) -> list[int]:
        """Retained steps whose save-time extras carry ``healthy: true``
        (ascending): the last-known-good ring."""
        out = []
        for step in self.all_steps():
            try:
                if self.read_extra(step).get("healthy"):
                    out.append(step)
            except (OSError, ValueError):
                continue  # unreadable step: never a rollback target
        return out

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def close(self) -> None:
        """Nothing to release."""


def checkpoint_algorithm(algo, directory: str | None = None,
                         wait: bool = False,
                         include_aux: bool = True,
                         overwrite: bool = False,
                         max_to_keep: int | None = None,
                         extra_meta: dict | None = None) -> CheckpointManager:
    """Save an algorithm's full state (the server's periodic, final and
    signal-path saves). The step number is the model version."""
    directory = directory or osp.join(".", "checkpoints")
    want_keep = max_to_keep or CheckpointManager.DEFAULT_MAX_TO_KEEP
    mgr = getattr(algo, "_ckpt_mgr", None)
    if (mgr is None or mgr.directory != osp.abspath(directory)
            or mgr.max_to_keep < want_keep):
        mgr = CheckpointManager(directory, max_to_keep=want_keep)
        algo._ckpt_mgr = mgr
    extra = {
        "epoch": int(getattr(algo, "epoch", 0)),
        "version": int(algo.version),
        "arch": algo.arch,
    }
    freeze_info = getattr(algo, "freeze_info", None)
    if freeze_info:
        extra["freeze"] = {k: v for k, v in freeze_info.items()
                           if k != "frozen_paths"}
    if extra_meta:
        # Caller metadata (the healthy-at-save tag); reserved keys win.
        extra = {**dict(extra_meta), **extra}
    # The save reads the live params: every dispatched update must have
    # finished writing them.
    win = getattr(algo, "_inflight", None)
    if win is not None and win.pending:
        win.drain()
    from relayrl_tpu_torch.parallel import distributed
    from relayrl_tpu_torch.weights import gathers_across_processes

    try:
        # The capture gathers a split that crosses processes: every
        # process takes part, and the coordinator writes.
        train = (capture_state(algo.state)
                 if distributed.is_coordinator() or any(
                     gathers_across_processes(v) for v in vars(algo.state).values()
                     if isinstance(v, torch.nn.Module))
                 else None)
        if distributed.is_coordinator():
            state = {"train": train, "rng": _rng_state(),
                     "epoch": extra["epoch"], "version": extra["version"]}
            aux = algo.checkpoint_aux() if include_aux else None
            mgr.save(int(algo.version), state, extra, wait=wait, aux=aux,
                     overwrite=overwrite)
    finally:
        # Collective: every process leaves once the coordinator's write
        # is in place (or has failed); a no-op for one process.
        distributed.barrier()
    return mgr


def restore_latest_healthy(algo, directory: str | None = None) -> int:
    """Roll ``algo`` back to the newest retained checkpoint tagged
    ``healthy: true``; returns its step. Raises FileNotFoundError when no
    healthy step is retained."""
    directory = directory or osp.join(".", "checkpoints")
    mgr = getattr(algo, "_ckpt_mgr", None)
    if mgr is None or mgr.directory != osp.abspath(directory):
        mgr = CheckpointManager(directory)
    healthy = mgr.healthy_steps()
    if not healthy:
        raise FileNotFoundError(
            f"no healthy-tagged checkpoint retained in {directory}")
    restore_algorithm(algo, directory, step=healthy[-1], manager=mgr)
    return healthy[-1]


def restore_algorithm(algo, directory: str | None = None,
                      step: int | None = None,
                      manager: CheckpointManager | None = None) -> None:
    """Restore a previously checkpointed algorithm in place, onto the
    device it lives on."""
    directory = directory or osp.join(".", "checkpoints")
    mgr = manager if manager is not None else CheckpointManager(directory)
    resolved = mgr.latest_step() if step is None else step
    if resolved is None:
        raise FileNotFoundError(f"no checkpoints in {mgr.directory}")
    # learner.freeze guard before the array restore: a mismatched mask
    # changes which parameters each optimizer holds.
    saved_freeze = (mgr.read_extra(resolved).get("freeze")
                    or {}).get("patterns", [])
    live_freeze = list((getattr(algo, "freeze_info", None)
                        or {}).get("patterns", []))
    if saved_freeze != live_freeze:
        raise ValueError(
            f"checkpoint learner.freeze {saved_freeze} != configured "
            f"{live_freeze}; align the config with the checkpointed "
            "mask (or retrain from scratch)")
    state, extra, aux = mgr.restore(resolved)
    if extra.get("arch") and json.dumps(extra["arch"], sort_keys=True) != \
            json.dumps(algo.arch, sort_keys=True):
        raise ValueError(
            f"checkpoint arch {extra.get('arch')} != algorithm arch {algo.arch}")
    win = getattr(algo, "_inflight", None)
    if win is not None and win.pending:
        win.drain()
    algo.state = apply_state(algo.state, state["train"])
    _set_rng_state(state.get("rng") or {})
    algo.epoch = int(state.get("epoch", extra.get("epoch", 0)))
    if aux is not None:
        algo.restore_aux(aux)


__all__ = ["CheckpointManager", "StepAlreadyExistsError",
           "checkpoint_algorithm", "restore_algorithm",
           "restore_latest_healthy", "capture_state", "apply_state",
           "train_state_digest"]
