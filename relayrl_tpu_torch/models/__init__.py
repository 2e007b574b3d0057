"""Policy model registry (the model-ABI layer).

Importing this package registers the ported model families.
"""

from relayrl_tpu_torch.models.base import (
    Policy,
    apply_arch_overrides,
    build_policy,
    mlp_sizes,
    register_model,
    resolve_device,
    validate_policy,
)
import relayrl_tpu_torch.models.mlp  # noqa: F401  (registers mlp_discrete, mlp_continuous)
import relayrl_tpu_torch.models.cnn  # noqa: F401  (registers cnn_discrete)
import relayrl_tpu_torch.models.q_networks  # noqa: F401  (registers the four off-policy kinds)
import relayrl_tpu_torch.models.transformer  # noqa: F401  (registers the three transformer kinds)

__all__ = ["Policy", "apply_arch_overrides", "build_policy", "mlp_sizes", "register_model",
           "resolve_device", "validate_policy"]
