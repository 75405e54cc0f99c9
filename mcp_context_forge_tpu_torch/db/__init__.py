"""Persistence: sqlite3 (stdlib) behind an async facade (a copy of the JAX
package's ``db/``). ``make_database`` (``pg.py``) builds the backend a
``database_url`` names; this slice of the port has the sqlite one."""

from .core import Database, Migration
from .schema import MIGRATIONS

__all__ = ["Database", "Migration", "MIGRATIONS"]
