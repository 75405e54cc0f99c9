"""Identifiers (``new_id`` also stays importable from here)."""

from __future__ import annotations

from .ids import new_id

__all__ = ["new_id"]
