"""Visualization of the port's stage outputs: Pymol scripts, EVzoom JSON
and mutation-effect matrices."""
