"""Frozen plain versions: see ``benchmark/reference/plain/__init__.py``."""
