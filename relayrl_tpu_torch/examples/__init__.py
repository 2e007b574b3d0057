"""Runnable twins of the JAX package's examples (``train_local.py``,
``train_memory.py``, ``train_distributed.py``) and of its crash-drill
server (``benches/_chaos_server.py`` as ``chaos_server``):
``python -m relayrl_tpu_torch.examples.<name>``."""
