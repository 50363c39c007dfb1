"""Utilities: the dependency-free TensorBoard event writer."""
