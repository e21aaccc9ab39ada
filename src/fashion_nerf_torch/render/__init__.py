"""Renderers: the blockwise early-terminated render path."""
