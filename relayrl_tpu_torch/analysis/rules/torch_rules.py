"""Torch hazard rules: the port's silent-throughput and replay killers.

The port's counterparts of the JAX package's ``jax_rules.py``. Each rule
targets a failure mode that gives *wrong numbers, broken replay
contracts or slow programs without an exception*: draws from torch's
process-wide RNG couple every thread's sample streams, host syncs and
prints inside a CUDA-graph capture raise or freeze one value into every
replay, wall-clock pairs around asynchronous CUDA work time the enqueue
instead of the compute, and an import of the JAX package puts JAX on a
host that has none.

JAX04 (untraceable argument without ``static_argnums``) and JAX05 (jit of
an update without ``donate_argnums``) have no counterpart: eager torch
traces nothing, so it has no static arguments, and it updates parameters
and optimizer state in place, so there is no input buffer to donate. A
CUDA graph pins its buffers at capture; what can go wrong there is what
TORCH02 and TORCH03 look for.
"""

from __future__ import annotations

import ast
from typing import Iterator

from relayrl_tpu_torch.analysis.engine import (
    ModuleInfo,
    Rule,
    module_scope_nodes,
    qualname,
    walk_skip_nested_functions,
)

# torch functions that draw from an RNG: ``generator=`` selects the
# stream, and without it the process-wide default generator is read.
_SAMPLERS = frozenset({
    "torch.rand", "torch.randn", "torch.randint", "torch.randperm",
    "torch.multinomial", "torch.bernoulli", "torch.normal",
    "torch.poisson",
})

# In-place samplers on a tensor (and their torch.nn.init twins).
_INPLACE_SAMPLERS = frozenset({
    "uniform_", "normal_", "bernoulli_", "exponential_", "random_",
    "geometric_", "cauchy_", "log_normal_",
})

_TIMING_CALLS = frozenset({
    "time.time", "time.time_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "time.monotonic", "time.monotonic_ns",
})

# Host readbacks: each waits for the work queued before it.
_READBACK_ATTRS = frozenset({"item", "cpu", "tolist", "numpy"})

# torch.* names that return no tensor (type objects, context managers,
# global settings, I/O): neither device work nor a tensor expression.
_NOT_TENSOR_OPS = frozenset({
    "device", "dtype", "Size", "finfo", "iinfo", "Generator",
    "no_grad", "inference_mode", "enable_grad", "set_grad_enabled",
    "is_grad_enabled", "manual_seed", "seed", "initial_seed",
    "get_rng_state", "set_rng_state", "is_tensor", "is_floating_point",
    "is_complex", "numel", "typename", "get_default_dtype",
    "set_default_dtype", "set_default_device", "set_printoptions",
    "set_num_threads", "get_num_threads", "set_float32_matmul_precision",
    "use_deterministic_algorithms", "compile", "load", "save",
    "from_numpy", "tensor", "as_tensor", "empty", "empty_like",
    "empty_strided", "broadcast_shapes", "result_type", "promote_types",
    "can_cast", "get_device",
})

# torch namespaces whose calls launch device work on device tensors.
_LAUNCH_NAMESPACES = ("torch.nn.functional.", "torch.linalg.", "torch.fft.",
                      "torch.special.")
_LAUNCH_CALLS = frozenset({"torch.autograd.grad", "torch.autograd.backward"})

# The port's kernel wrappers and their plain versions: each call
# launches device work (the modules' factories and checks do not).
_KERNEL_WRAPPERS = frozenset(
    [f"relayrl_tpu_torch.ops.flash.{name}" for name in (
        "flash_attention", "flash_attention_plain", "flash_attention_delta",
        "flash_attention_dq_plain", "flash_attention_dkv_plain",
        "flash_attention_bwd_plain", "prescale_q")]
    + [f"relayrl_tpu_torch.parallel.ring_flash.{name}" for name in (
        "chunk_fwd", "chunk_dq", "chunk_dkv", "chunk_fwd_plain",
        "chunk_dq_plain", "chunk_dkv_plain", "ring_flash_attention_sharded",
        "chunked_flash_local", "prescale_q")])

# Tensor methods that read metadata only: no launch.
_METADATA_METHODS = frozenset({
    "numel", "nelement", "size", "dim", "ndimension", "element_size",
    "stride", "storage_offset", "is_contiguous", "data_ptr", "get_device",
    "type", "requires_grad_", "register_hook", "parameters",
    "named_parameters", "buffers", "named_buffers", "state_dict",
    "modules", "children", "train", "eval",
})

# Methods whose result stays a tensor when their receiver is one.
_TENSOR_METHODS = frozenset({
    "sum", "mean", "max", "min", "amax", "amin", "any", "all", "norm",
    "argmax", "argmin", "prod", "std", "var", "abs", "clone", "detach",
    "float", "double", "half", "bfloat16", "int", "long", "bool", "to",
    "exp", "log", "sqrt", "square", "count_nonzero", "reshape", "view",
    "flatten", "squeeze", "unsqueeze", "contiguous", "gather",
    "masked_select", "nonzero", "eq", "ne", "gt", "lt", "ge", "le",
    "isfinite", "isnan", "logical_and", "logical_or", "logical_not",
})

# Modules whose top-level name the port may not import (PORT01).
_REFERENCE_MODULES = frozenset({"relayrl_tpu", "jax", "jaxlib", "flax",
                                "optax", "orbax"})
# Modules the port imports only inside the functions that need them.
_LAZY_MODULES = frozenset({"msgpack", "ml_dtypes"})


def _is_torch_tensor_call(resolved: str | None) -> bool:
    if not resolved or not resolved.startswith("torch."):
        return False
    rest = resolved[len("torch."):]
    if "." not in rest:
        return rest not in _NOT_TENSOR_OPS
    return (resolved.startswith(_LAUNCH_NAMESPACES)
            or resolved in _LAUNCH_CALLS)


def cpu_literal(node: ast.AST) -> bool:
    """``"cpu"``, ``torch.device("cpu")`` and the like: a device the
    analyzer can read as the host's."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value.startswith("cpu")
    if isinstance(node, ast.Call) and node.args:
        return cpu_literal(node.args[0])
    return False


def device_kw_not_cpu(call: ast.Call) -> bool:
    """The call passes ``device=`` something other than the host's."""
    return any(kw.arg == "device" and not cpu_literal(kw.value)
               for kw in call.keywords)


def device_copy_label(call: ast.Call) -> str | None:
    """``.cuda()`` or ``.to("cuda...")``: a copy from the host to a card."""
    func = call.func
    if not isinstance(func, ast.Attribute):
        return None
    if func.attr == "cuda":
        return ".cuda()"
    if (func.attr == "to" and call.args
            and isinstance(call.args[0], ast.Constant)
            and isinstance(call.args[0].value, str)
            and call.args[0].value.startswith("cuda")):
        return f".to({call.args[0].value!r})"
    return None


class _TensorNames:
    """Names bound, in one body, to a tensor expression: the results of
    torch calls, of tensor methods on them, of indexing and arithmetic
    on them. A one-pass flow model: precision over recall."""

    def __init__(self, module: ModuleInfo, nodes: list[ast.AST]):
        self.module = module
        self.names: set[str] = set()
        assigns = [n for n in nodes if isinstance(n, (ast.Assign,
                                                      ast.AnnAssign))]
        assigns.sort(key=lambda n: (n.lineno, n.col_offset))
        for _ in range(2):
            for node in assigns:
                if node.value is None or not self.is_tensor(node.value):
                    continue
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for target in targets:
                    elts = (target.elts if isinstance(target, ast.Tuple)
                            else [target])
                    for el in elts:
                        if isinstance(el, ast.Name):
                            self.names.add(el.id)

    def is_tensor(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Call):
            if _is_torch_tensor_call(self.module.resolved_call(node)):
                return True
            func = node.func
            return (isinstance(func, ast.Attribute)
                    and func.attr in _TENSOR_METHODS
                    and self.is_tensor(func.value))
        if isinstance(node, ast.Subscript):
            return self.is_tensor(node.value)
        if isinstance(node, ast.BinOp):
            return self.is_tensor(node.left) or self.is_tensor(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_tensor(node.operand)
        return False


class ImplicitGlobalRng(Rule):
    """A sampling call with no ``generator=`` reads torch's process-wide
    RNG, so its draws depend on every other thread's draws (an actor
    host's sampler beside a learner's dropout, a server's probes beside
    its replay). The port's replay contracts — served against local,
    fused against vector, graph against eager — hold only for draws from
    an explicit ``torch.Generator`` that the caller owns."""

    code = "TORCH01"
    name = "implicit-global-rng"
    description = ("torch sampling call without generator= reads the "
                   "process-wide RNG")

    def check(self, module: ModuleInfo) -> Iterator[tuple[ast.AST, str]]:
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call) or self._has_generator(node):
                continue
            resolved = module.resolved_call(node)
            if resolved in _SAMPLERS:
                label = resolved
            elif (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _INPLACE_SAMPLERS
                    and not isinstance(node.func.value, ast.Constant)):
                label = f".{node.func.attr}()"
            else:
                continue
            yield node, (
                f"`{label}` without `generator=` draws from torch's "
                f"process-wide RNG — its values depend on every other "
                f"draw in the process; pass an explicit torch.Generator "
                f"owned by the caller")

    @staticmethod
    def _has_generator(call: ast.Call) -> bool:
        for kw in call.keywords:
            if kw.arg == "generator":
                return not (isinstance(kw.value, ast.Constant)
                            and kw.value.value is None)
            if kw.arg is None:
                return True  # **kwargs may carry it
        return False


class HostSyncInCapture(Rule):
    """A host readback inside a CUDA-graph capture raises (the capturing
    stream may not synchronize) or, where it slips through, runs once at
    capture and freezes that value into every replay; a Python scalar
    copied to the device is likewise copied once, at capture."""

    code = "TORCH02"
    name = "host-sync-in-capture"
    description = ("host readback, synchronize or host-to-device copy "
                   "inside code captured into a CUDA graph")

    _CASTS = frozenset({"float", "int", "bool"})

    def check(self, module: ModuleInfo) -> Iterator[tuple[ast.AST, str]]:
        seen: set[tuple[int, int]] = set()
        for nodes in module.capture_bodies():
            tensors = _TensorNames(module, nodes)
            for node in nodes:
                if not isinstance(node, ast.Call):
                    continue
                mark = (node.lineno, node.col_offset)
                if mark in seen:
                    continue
                msg = self._diagnose(module, tensors, node)
                if msg:
                    seen.add(mark)
                    yield node, msg

    def _diagnose(self, module: ModuleInfo, tensors: _TensorNames,
                  call: ast.Call) -> str | None:
        resolved = module.resolved_call(call)
        if resolved == "torch.cuda.synchronize":
            return ("`torch.cuda.synchronize()` inside a CUDA-graph "
                    "capture — a capturing stream may not synchronize; "
                    "synchronize before capturing or after a replay")
        if (isinstance(call.func, ast.Attribute)
                and call.func.attr in _READBACK_ATTRS
                and not isinstance(call.func.value, ast.Constant)
                and not call.args):
            return (f"`.{call.func.attr}()` inside a CUDA-graph capture "
                    f"reads the device from the host: it raises at "
                    f"capture, or runs once and freezes its value into "
                    f"every replay; keep the value on the device")
        if (resolved in self._CASTS and len(call.args) == 1
                and tensors.is_tensor(call.args[0])):
            return (f"`{resolved}()` of a tensor inside a CUDA-graph "
                    f"capture forces a host sync; keep the value on the "
                    f"device or read it after a replay")
        if (resolved in ("numpy.asarray", "numpy.array") and call.args
                and tensors.is_tensor(call.args[0])):
            return (f"`{qualname(call.func)}` of a tensor inside a "
                    f"CUDA-graph capture copies it to the host once, at "
                    f"capture; read it after a replay")
        if (resolved in ("torch.tensor", "torch.as_tensor")
                and device_kw_not_cpu(call)):
            return (f"`{resolved}(..., device=...)` inside a CUDA-graph "
                    f"capture copies a host value to the device once, at "
                    f"capture, and every replay reuses it; build the "
                    f"tensor before capturing and update it in place")
        label = device_copy_label(call)
        if label:
            return (f"`{label}` inside a CUDA-graph capture copies host "
                    f"memory to the device once, at capture; copy into a "
                    f"captured buffer before each replay instead")
        return None


class PrintInCapture(Rule):
    """``print`` in captured code runs once, at capture, and never in a
    replay: the output describes the capture, not a step."""

    code = "TORCH03"
    name = "print-in-capture"
    description = "python print() inside code captured into a CUDA graph"

    def check(self, module: ModuleInfo) -> Iterator[tuple[ast.AST, str]]:
        seen: set[tuple[int, int]] = set()
        for nodes in module.capture_bodies():
            for node in nodes:
                if (isinstance(node, ast.Call)
                        and module.resolved_call(node) == "print"
                        and (node.lineno, node.col_offset) not in seen):
                    seen.add((node.lineno, node.col_offset))
                    yield node, (
                        "print() inside a CUDA-graph capture runs once, "
                        "at capture, and in no replay; print from the "
                        "host after a replay")


class UntimedCudaDispatch(Rule):
    """CUDA launches return before the device finishes; a wall-clock pair
    around one measures the *enqueue*, not the compute. Every such
    measurement needs a sync (``torch.cuda.synchronize()``, an event's
    ``synchronize``/``elapsed_time``, or a host readback) before the
    closing timestamp."""

    code = "TORCH06"
    name = "untimed-cuda-dispatch"
    description = ("device work timed with time.*() pairs but no CUDA "
                   "sync in the function")

    def check(self, module: ModuleInfo) -> Iterator[tuple[ast.AST, str]]:
        for fn in ast.walk(module.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if self._has_sync(module, fn):
                continue
            nodes = list(walk_skip_nested_functions(fn))
            timings: list[tuple[int, int]] = []
            work: list[ast.Call] = []
            bound = self._bound_device_names(module, nodes)
            for node in nodes:
                if not isinstance(node, ast.Call):
                    continue
                if module.resolved_call(node) in _TIMING_CALLS:
                    timings.append((node.lineno, node.col_offset))
                elif self._is_device_work(module, bound, node):
                    work.append(node)
            if len(timings) < 2 or not work:
                continue
            first, last = min(timings), max(timings)
            for call in work:
                if first < (call.lineno, call.col_offset) < last:
                    yield call, (
                        "device work timed without a CUDA sync — launches "
                        "are asynchronous, so this measures enqueue "
                        "latency, not device compute; call "
                        "torch.cuda.synchronize() (or read a result back) "
                        "before the closing timestamp")
                    break  # one report per function is enough

    @staticmethod
    def _has_sync(module: ModuleInfo, fn: ast.AST) -> bool:
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            if module.resolved_call(node) == "torch.cuda.synchronize":
                return True
            if (isinstance(node.func, ast.Attribute)
                    and not isinstance(node.func.value, ast.Constant)
                    and node.func.attr in (_READBACK_ATTRS
                                           | {"synchronize",
                                              "elapsed_time"})):
                return True
        return False

    @staticmethod
    def _bound_device_names(module: ModuleInfo,
                            nodes: list[ast.AST]) -> set[str]:
        """Names bound in the function to a tensor (a torch call's
        result, a ``.to``/``.cuda`` copy), an ``nn.Module`` or a CUDA
        graph."""
        names: set[str] = set()
        for node in nodes:
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                continue
            resolved = module.resolved_call(node.value) or ""
            func = node.value.func
            if not (_is_torch_tensor_call(resolved)
                    or resolved.startswith("torch.nn.")
                    or resolved.startswith("torch.cuda.CUDAGraph")
                    or (isinstance(func, ast.Attribute)
                        and func.attr in ("to", "cuda"))):
                continue
            for target in node.targets:
                elts = (target.elts if isinstance(target, ast.Tuple)
                        else [target])
                names.update(el.id for el in elts
                             if isinstance(el, ast.Name))
        return names

    @staticmethod
    def _is_device_work(module: ModuleInfo, bound: set[str],
                        call: ast.Call) -> bool:
        resolved = module.resolved_call(call)
        if _is_torch_tensor_call(resolved):
            return True
        if resolved in _KERNEL_WRAPPERS:
            return True
        func = call.func
        if isinstance(func, ast.Name):
            return func.id in bound
        if not isinstance(func, ast.Attribute):
            return False
        if func.attr == "replay" and not call.args:
            # a CUDA graph's replay: a receiver bound to one here, or
            # named for one (``self.graph``, ``self._graphs[k]``)
            receiver = qualname(func.value)
            if isinstance(func.value, ast.Subscript):
                receiver = qualname(func.value.value)
            if receiver in bound:
                return True
            return bool(receiver) and "graph" in receiver.rsplit(
                ".", 1)[-1].lower()
        return (isinstance(func.value, ast.Name) and func.value.id in bound
                and func.attr not in _METADATA_METHODS)


class ReferenceImport(Rule):
    """The port never imports the JAX package or JAX itself: either would
    put JAX on a GPU host that has none (``relayrl_tpu``'s packaging
    makes ``jax`` a hard dependency). ``msgpack`` and ``ml_dtypes`` are
    imported inside the functions that encode or decode, because the GPU
    host's package list does not promise them."""

    code = "PORT01"
    name = "reference-import"
    description = ("import of relayrl_tpu/jax/flax/optax/orbax, or a "
                   "module-scope msgpack/ml_dtypes import, in the port")

    def check(self, module: ModuleInfo) -> Iterator[tuple[ast.AST, str]]:
        module_scope = {id(n) for n in module_scope_nodes(module.tree)}
        for node in ast.walk(module.tree):
            for top in self._imported_tops(node):
                if top in _REFERENCE_MODULES:
                    yield node, (
                        f"`{top}` imported by the port — the port never "
                        f"loads JAX or the JAX package; keep a copy of "
                        f"what it needs under relayrl_tpu_torch")
                elif top in _LAZY_MODULES and id(node) in module_scope:
                    yield node, (
                        f"`{top}` imported at module scope — the port "
                        f"imports it inside the functions that encode or "
                        f"decode, so importing the port never needs it")

    @staticmethod
    def _imported_tops(node: ast.AST) -> list[str]:
        if isinstance(node, ast.Import):
            return [a.name.split(".")[0] for a in node.names]
        if isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            return [node.module.split(".")[0]]
        return []


RULES = [
    ImplicitGlobalRng,
    HostSyncInCapture,
    PrintInCapture,
    UntimedCudaDispatch,
    ReferenceImport,
]
