"""Tensor ops of the path tracer (the plain versions) and the kernel tier."""
