"""Utilities: PNG writing."""
