"""Config system: a copy of :mod:`relayrl_tpu.config`."""

from relayrl_tpu_torch.config.default_config import (
    DEFAULT_CONFIG,
    SUPPORTED_ALGORITHMS,
    default_config,
)
from relayrl_tpu_torch.config.loader import (
    DEFAULT_CONFIG_FILENAME,
    ConfigLoader,
    Endpoint,
    resolve_config_path,
)

__all__ = [
    "DEFAULT_CONFIG",
    "SUPPORTED_ALGORITHMS",
    "default_config",
    "ConfigLoader",
    "Endpoint",
    "resolve_config_path",
    "DEFAULT_CONFIG_FILENAME",
]
