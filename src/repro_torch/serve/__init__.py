"""Serving engines."""
