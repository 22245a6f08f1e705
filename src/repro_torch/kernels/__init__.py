"""Scan kernels: hand-written CUDA for Hopper (``csrc/``), their plain
PyTorch versions, and the ``ops`` wrappers the core modules call."""
