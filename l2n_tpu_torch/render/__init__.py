"""Render layer: tile schedule, frame state, step, programs, renderer."""
