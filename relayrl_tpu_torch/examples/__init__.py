"""Runnable twins of the JAX package's ``examples/train_local.py`` and
``examples/train_memory.py``: ``python -m relayrl_tpu_torch.examples.<name>``."""
