"""Attention ops: plain tensor versions and the CUDA flash forward."""
