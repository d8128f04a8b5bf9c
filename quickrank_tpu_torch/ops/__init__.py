"""Scoring operations and the CUDA kernels' wrappers."""
