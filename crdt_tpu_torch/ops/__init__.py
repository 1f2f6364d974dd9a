"""Tensor operations of the port: lanes, folds and the kernel wrappers."""
