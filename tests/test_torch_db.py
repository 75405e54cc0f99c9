"""The port's database (``db/core.py``, ``db/schema.py``, ``db/pg.py``)
against the JAX package's, on the CPU: after ``migrate`` both packages'
``sqlite_master`` hold the same SQL and a second ``migrate`` is a no-op in
both; the same statements give the same rows (``execute``, ``fetchone``,
``fetchall``, ``executemany``, ``transaction`` and its rollback, the WAL
reader lanes and the statement cache); a file either package wrote opens in
the other; ``to_json``/``from_json``, the read-only routing, the query log,
the phase charges and the fault points agree; ``make_database`` gives the
same sqlite paths and refuses a PostgreSQL URL."""

import sqlite3

import pytest

from mcp_context_forge_tpu.db import core as jax_core
from mcp_context_forge_tpu.db import pg as jax_pg
from mcp_context_forge_tpu.db.schema import MIGRATIONS as JAX_MIGRATIONS
from mcp_context_forge_tpu.observability import phases as jax_phases
from mcp_context_forge_tpu_torch.db import MIGRATIONS, core
from mcp_context_forge_tpu_torch.db.pg import UnsupportedDatabase, make_database
from mcp_context_forge_tpu_torch.observability import phases

PACKAGES = {"jax": (jax_core, JAX_MIGRATIONS), "port": (core, MIGRATIONS)}
MASTER = "SELECT type, name, tbl_name, sql FROM sqlite_master ORDER BY type, name"


async def _migrated(package: str, path: str = ":memory:", pool_size: int = 1):
    module, migrations = PACKAGES[package]
    db = module.Database(path, pool_size=pool_size)
    await db.connect()
    applied = await db.migrate(migrations)
    return db, applied


async def test_schema_equal_and_second_migrate_is_a_noop():
    dbs = {}
    for name in PACKAGES:
        db, applied = await _migrated(name)
        assert applied == len(MIGRATIONS) == len(JAX_MIGRATIONS)
        assert await db.migrate(PACKAGES[name][1]) == 0
        dbs[name] = db
    jax_master, port_master = [await dbs[n].fetchall(MASTER) for n in PACKAGES]
    assert port_master == jax_master
    assert {r["name"] for r in port_master} >= {"llm_providers", "llm_models",
                                                "plugin_bindings", "tenant_usage"}
    versions = [await dbs[n].fetchall("SELECT version, name FROM schema_migrations"
                                      " ORDER BY version") for n in PACKAGES]
    assert versions[0] == versions[1]
    assert [(m.version, m.name, m.sql) for m in MIGRATIONS] == \
        [(m.version, m.name, m.sql) for m in JAX_MIGRATIONS]
    for db in dbs.values():
        await db.close()


async def _statements(db) -> list:
    """One transcript of every statement kind over ``plugin_bindings``."""
    out = []
    insert = ("INSERT INTO plugin_bindings (id, plugin_name, scope_type, scope_id, mode,"
              " config, enabled, created_at) VALUES (?,?,?,?,?,?,?,?)")
    out.append(await db.execute(insert, ("b1", "summarizer", "tool", "t1", "enforce",
                                         core.to_json({"max_tokens": 8}), 1, 1.0)))
    await db.executemany(insert, [(f"b{i}", "content_moderation", "global", None,
                                   "permissive", "{}", i % 2, float(i)) for i in range(2, 6)])
    out.append(await db.fetchone("SELECT * FROM plugin_bindings WHERE id=?", ("b1",)))
    out.append(await db.fetchone("SELECT * FROM plugin_bindings WHERE id=?", ("none",)))
    out.append(await db.fetchall("SELECT id, enabled FROM plugin_bindings WHERE enabled=1"
                                 " ORDER BY created_at"))
    await db.transaction([("UPDATE plugin_bindings SET mode=? WHERE id=?", ("disabled", "b2")),
                          ("DELETE FROM plugin_bindings WHERE id=?", ("b3",))])
    with pytest.raises(sqlite3.IntegrityError):
        # the duplicate id fails the second statement: the first rolls back
        await db.transaction([("UPDATE plugin_bindings SET mode='x' WHERE id='b4'", ()),
                              (insert, ("b1", "k", "tool", None, "enforce", "{}", 1, 9.0))])
    out.append(await db.fetchall("SELECT id, mode FROM plugin_bindings ORDER BY id"))
    out.append(await db.execute("SELECT count(*) AS n FROM plugin_bindings"))
    out.append(await db.execute(
        "WITH x AS (SELECT id FROM plugin_bindings) SELECT count(*) AS n FROM x"))
    return out


@pytest.mark.parametrize("pool_size", [1, 3])
async def test_statements_give_the_same_rows(tmp_path, pool_size):
    transcripts, caches = [], []
    for name in PACKAGES:
        db, _ = await _migrated(name, str(tmp_path / f"{name}.db"), pool_size=pool_size)
        assert db.pool_size == pool_size
        transcripts.append(await _statements(db))
        caches.append({k: v for k, v in db.statement_cache.stats().items()})
        await db.close()
    assert transcripts[1] == transcripts[0]
    assert transcripts[1][1]["config"] == '{"max_tokens":8}'
    assert caches[1] == caches[0]


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
async def test_a_file_one_package_wrote_opens_in_the_other(tmp_path, writer, reader):
    path = str(tmp_path / "gateway.db")
    db, _ = await _migrated(writer, path)
    await db.execute("INSERT INTO tenant_usage (tenant, window_start, window_end, requests,"
                     " prompt_tokens, generated_tokens, cache_hit_tokens, kv_page_seconds)"
                     " VALUES (?,?,?,?,?,?,?,?)", ("team:a", 1.5, 2.5, 3, 40, 7, 8, 0.25))
    await db.close()
    db, applied = await _migrated(reader, path)
    assert applied == 0
    rows = await db.fetchall("SELECT * FROM tenant_usage")
    assert [(r["tenant"], r["prompt_tokens"], r["kv_page_seconds"]) for r in rows] == \
        [("team:a", 40, 0.25)]
    await db.close()


@pytest.mark.parametrize("value", [None, 0, 1.5, "é x", [1, {"a": None}], {"k": [True, "v"]}])
def test_to_json_agrees(value):
    assert core.to_json(value) == jax_core.to_json(value)
    assert core.from_json(core.to_json(value)) == jax_core.from_json(jax_core.to_json(value))


@pytest.mark.parametrize("text", [None, "", "{bad", "[1,2]", "7", '"s"'])
def test_from_json_agrees(text):
    assert core.from_json(text, default="d") == jax_core.from_json(text, default="d")


@pytest.mark.parametrize("sql", [
    "SELECT 1", "  select * from t", "EXPLAIN SELECT 1", "VALUES (1)", "INSERT INTO t VALUES (1)",
    "WITH x AS (SELECT 1) SELECT * FROM x", "WITH x AS (SELECT 1) DELETE FROM t",
    "WITH x AS (SELECT 'insert') SELECT * FROM x", "", "PRAGMA foreign_keys"])
def test_read_only_routing_agrees(sql):
    assert core._is_read_only(sql) == jax_core._is_read_only(sql)


async def test_query_log_and_phase_charges_agree():
    logs, charged = [], []
    for name, clock_module in (("jax", jax_phases), ("port", phases)):
        module = PACKAGES[name][0]
        db, _ = await _migrated(name)
        clock = clock_module.PhaseClock()
        token = clock_module.set_phase_clock(clock)
        try:
            with module.query_log_capture() as log:
                await db.execute("SELECT  id FROM\n plugin_bindings")
                await db.fetchall("SELECT count(*) FROM tools")
        finally:
            clock_module.reset_phase_clock(token)
        logs.append([sql for sql, _ in log])
        charged.append(sorted(clock.phases))
        await db.close()
    assert logs[1] == logs[0] == ["SELECT id FROM plugin_bindings", "SELECT count(*) FROM tools"]
    assert charged[1] == charged[0] == ["db.acquire", "db.execute"]


async def test_fault_points_carry_the_same_names(monkeypatch):
    seen = {}
    for name in PACKAGES:
        module = PACKAGES[name][0]
        calls = seen[name] = []
        monkeypatch.setattr(module, "fault_point",
                            lambda point, scope=None, calls=calls: calls.append((point, scope)))
        db, _ = await _migrated(name)
        await db.execute("SELECT 1")
        await db.executemany("INSERT INTO tenant_usage (tenant, window_start, window_end)"
                             " VALUES (?,?,?)", [("t", 1.0, 2.0)])
        await db.close()
    assert seen["port"] == seen["jax"]
    assert [point for point, _ in seen["port"]] == ["db.execute", "db.execute"]


def test_supports_returning_agrees():
    assert core.Database.supports_returning == jax_core.Database.supports_returning == \
        (sqlite3.sqlite_version_info >= (3, 35, 0))


@pytest.mark.parametrize("url,pool_size", [
    ("sqlite:///:memory:", 8), ("sqlite:///./gateway.db", 8), ("sqlite:////var/x/g.db", 2),
    ("sqlite+aiosqlite:///rel/g.db", 1), ("sqlite:///", 4), ("sqlite:///file:x?mode=memory", 3)])
def test_make_database_gives_the_same_sqlite_database(url, pool_size):
    port = make_database(url, pool_size, busy_timeout_ms=500, max_retries=5,
                         retry_interval_ms=7.0)
    ref = jax_pg.make_database(url, pool_size, busy_timeout_ms=500, max_retries=5,
                               retry_interval_ms=7.0)
    assert isinstance(port, core.Database)
    for attr in ("_path", "_busy_timeout_ms", "_max_retries", "_retry_interval_s", "pool_size"):
        assert getattr(port, attr) == getattr(ref, attr), attr


@pytest.mark.parametrize("url", ["postgres://u:p@h/db", "postgresql://u:p@h:5432/db"])
def test_make_database_refuses_postgresql(url):
    with pytest.raises(UnsupportedDatabase, match="PostgreSQL"):
        make_database(url)
