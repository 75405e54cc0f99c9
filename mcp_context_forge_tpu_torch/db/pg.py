"""The database factory (``make_database`` of the JAX package's
``db/pg.py``). A sqlite URL (a file, or ``:memory:``) gives the sqlite
``Database``; a ``postgres://`` or ``postgresql://`` URL raises
``UnsupportedDatabase``: the port has no PostgreSQL backend (the JAX
package's wire driver, dialect translator and wire server) yet."""

from __future__ import annotations

from .core import Database


class UnsupportedDatabase(RuntimeError):
    """A database URL whose backend the port does not have."""


def make_database(database_url: str, pool_size: int = 8,
                  busy_timeout_ms: int = 10000, max_retries: int = 3,
                  retry_interval_ms: float = 50.0) -> Database:
    """The backend of ``database_url``. sqlite gets the ``pool_size`` knob:
    writes stay on one writer lane, ``pool_size - 1`` WAL reader lanes take
    read-only statements (an in-memory path collapses to one lane)."""
    if database_url.startswith(("postgres://", "postgresql://")):
        raise UnsupportedDatabase(
            "database_url names PostgreSQL, but this package has no PostgreSQL "
            "backend yet; use a sqlite:/// URL")
    return Database(database_url.split("///", 1)[-1] or ":memory:",
                    busy_timeout_ms=busy_timeout_ms,
                    max_retries=max_retries,
                    retry_interval_ms=retry_interval_ms,
                    pool_size=pool_size)
