"""Alignment reading."""
