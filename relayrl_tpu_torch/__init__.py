"""PyTorch/CUDA port of relayrl_tpu, beside the JAX package it is held to.

The layout mirrors ``relayrl_tpu`` (``types/``, ``ops/``, ``models/``,
``runtime/``, ``envs/``), so each module's counterpart sits at the same
path. The port imports torch and never JAX or anything of ``relayrl_tpu``.
Hand-written CUDA kernels live in ``csrc/`` and are built at first use by
:mod:`relayrl_tpu_torch._kernels`. Entry points run on the GPU unless the
caller passes ``device="cpu"``.
"""
