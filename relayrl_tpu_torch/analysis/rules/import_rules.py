"""Import-hygiene rules.

``import relayrl_tpu_torch.anything`` must stay side-effect free: actor
processes import types+config only, the CPU test suite imports every
module on hosts with no GPU, and a module-level CUDA call creates a
context on the importer's current device before the runtime has chosen
one (rank processes pick their card from ``LOCAL_RANK`` after import).
Global torch state set at import time changes every importer's numerics.
"""

from __future__ import annotations

import ast
from typing import Iterator

from relayrl_tpu_torch.analysis.engine import (
    ModuleInfo,
    Rule,
    module_scope_nodes,
    qualname,
)
from relayrl_tpu_torch.analysis.rules.torch_rules import (
    device_copy_label,
    device_kw_not_cpu,
)

# torch.cuda calls that create (or bind) a CUDA context.
_CONTEXT_CALLS = frozenset({
    "torch.cuda.init",
    "torch.cuda.set_device",
    "torch.cuda.current_device",
    "torch.cuda.synchronize",
    "torch.cuda.Stream",
    "torch.cuda.Event",
    "torch.cuda.current_stream",
    "torch.cuda.default_stream",
    "torch.cuda.mem_get_info",
    "torch.cuda.caching_allocator_alloc",
})

# Process-global torch state.
_GLOBAL_STATE_CALLS = frozenset({
    "torch.set_default_device",
    "torch.set_default_dtype",
    "torch.manual_seed",
})

# Tensor factories that allocate on ``device=``.
_FACTORIES = frozenset({
    "tensor", "as_tensor", "zeros", "ones", "empty", "full", "arange",
    "linspace", "eye", "rand", "randn", "randint", "randperm",
    "zeros_like", "ones_like", "empty_like", "full_like",
})

# Files whose whole job is import-time environment setup.
_EXEMPT_BASENAMES = frozenset({"__init__.py", "conftest.py"})


class ModuleLevelDeviceTouch(Rule):
    """A CUDA call, a device allocation or a global torch setting at
    module scope runs at import time: it creates a CUDA context on
    whatever device is current for every importer (a rank process then
    holds a context on the wrong card), fails on a host with no GPU, or
    changes every importer's seed, dtype or backend flags. All of these
    belong inside functions, called by whoever owns process setup."""

    code = "IMP01"
    name = "module-level-device-touch"
    description = ("module-scope torch.cuda call, device allocation, "
                   "seed, default or torch.backends mutation outside "
                   "__init__")

    def check(self, module: ModuleInfo) -> Iterator[tuple[ast.AST, str]]:
        basename = module.path.rsplit("/", 1)[-1]
        if basename in _EXEMPT_BASENAMES:
            return
        for node in module_scope_nodes(module.tree):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for target in targets:
                    resolved = module.resolve(qualname(target))
                    if resolved and resolved.startswith("torch.backends."):
                        yield node, (
                            f"`{resolved}` assigned at module scope changes "
                            f"the backend's numerics for every importer; "
                            f"set it inside a function on the "
                            f"process-setup path")
                continue
            if not isinstance(node, ast.Call):
                continue
            label = self._label(module, node)
            if label:
                yield node, (
                    f"`{label}` at module scope runs at import time — it "
                    f"creates a CUDA context on the importer's current "
                    f"device (or sets global torch state) for every "
                    f"importer; move it inside a function on the "
                    f"process-setup path")

    @staticmethod
    def _label(module: ModuleInfo, call: ast.Call) -> str | None:
        resolved = module.resolved_call(call)
        if resolved in _CONTEXT_CALLS or resolved in _GLOBAL_STATE_CALLS:
            return resolved
        if (resolved and resolved.startswith("torch.")
                and resolved.split(".", 1)[1] in _FACTORIES):
            return (f"{resolved}(device=...)" if device_kw_not_cpu(call)
                    else None)
        return device_copy_label(call)


RULES = [ModuleLevelDeviceTouch]
