"""The port's ``TenantUsageRollup`` (``observability/metering.py``) against
the JAX package's, on the CPU: the rollup cases of JAX's
``tests/unit/test_tenant_metering.py`` run on both packages with the same
ledger adds and a failing database stand-in, giving the same rows (window
stamps included), pending buffer, drop counts and breaker states; over each
package's migrated sqlite database both flush the same ``tenant_usage``
rows and ``recent()`` reads them back alike; an armed
``ledger.rollup.flush`` fault point parks the window in both, and the next
flush writes it under its original stamps."""

import asyncio
import time

import pytest

from mcp_context_forge_tpu.db import core as jax_core
from mcp_context_forge_tpu.db.schema import MIGRATIONS as JAX_MIGRATIONS
from mcp_context_forge_tpu.observability import degradation as jax_degradation
from mcp_context_forge_tpu.observability import faults as jax_faults
from mcp_context_forge_tpu.observability import metering as jax_metering
from mcp_context_forge_tpu_torch.db import MIGRATIONS, core
from mcp_context_forge_tpu_torch.observability import degradation, faults, metering

PACKAGES = {
    "jax": (jax_metering, jax_degradation, jax_faults, jax_core, JAX_MIGRATIONS),
    "port": (metering, degradation, faults, core, MIGRATIONS),
}


class _FakeDb:
    def __init__(self, fail=False):
        self.rows = []
        self.fail = fail
        self.attempts = 0

    async def executemany(self, sql, seq):
        self.attempts += 1
        if self.fail:
            raise RuntimeError("db down")
        self.rows.extend(seq)


class _Clock:
    """``time.time`` of one package's metering module, stepping 1 s a call,
    so that both packages stamp their windows alike."""

    def __init__(self, monkeypatch, module):
        self.now = 1000.0
        monkeypatch.setattr(module.time, "time", self)

    def __call__(self):
        self.now += 1.0
        return self.now


def _flush(rollup, **kwargs):
    try:
        return asyncio.run(rollup.flush(**kwargs))
    except RuntimeError as exc:
        return f"raised: {exc}"


def _case_flush_writes_rows(pkg):
    module = pkg[0]
    ledger = module.TenantLedger()
    ledger.add("team:a", requests=2, prompt_tokens=10, generated_tokens=4)
    ledger.add("team:b", prompt_tokens=7, cache_hit_tokens=3)
    db = _FakeDb()
    rollup = module.TenantUsageRollup(db, ledger, interval_s=60)
    return [_flush(rollup), list(db.rows), ledger.column_sums(), _flush(rollup),
            ledger.rollups_written]


def _case_failure_parks_and_retries(pkg):
    module, deg = pkg[0], pkg[1]
    deg.configure_degradation(failure_threshold=3, cooldown_s=0.0)
    ledger = module.TenantLedger(quota_tokens_per_window=100)
    ledger.add("team:a", prompt_tokens=10)
    original_start = ledger._window_started
    db = _FakeDb(fail=True)
    rollup = module.TenantUsageRollup(db, ledger, interval_s=60)
    out = [_flush(rollup), rollup.outage_stats()["pending_windows"],
           rollup.consecutive_failures, ledger.column_sums()["prompt_tokens"]]
    db.fail = False
    out += [_flush(rollup), list(db.rows), db.rows[0][1] == original_start,
            rollup.outage_stats()["pending_windows"], rollup.consecutive_failures]
    return out


def _case_sustained_outage(pkg):
    module, deg = pkg[0], pkg[1]
    deg.configure_degradation(failure_threshold=3, cooldown_s=0.01)
    ledger = module.TenantLedger()
    db = _FakeDb(fail=True)
    rollup = module.TenantUsageRollup(db, ledger, interval_s=60, pending_max=3)
    starts, outcomes = [], []
    for i in range(6):
        ledger.add("team:a", prompt_tokens=10 + i)
        starts.append(ledger._window_started)
        outcomes.append(_flush(rollup))
    stats = rollup.outage_stats()
    out = [outcomes, {k: stats[k] for k in ("pending_windows", "windows_dropped",
                                            "tokens_dropped", "consecutive_failures")},
           stats["breaker"]["state"], deg.get_degradation().component_state("ledger.rollup"),
           ledger.column_sums()["prompt_tokens"], db.attempts]
    time.sleep(0.02)
    db.fail = False
    out += [_flush(rollup), rollup.outage_stats()["pending_windows"],
            rollup.outage_stats()["breaker"]["state"],
            sorted(r[1] for r in db.rows) == sorted(starts[3:]),
            [t["to"] for t in deg.get_degradation().transitions("ledger.rollup")]]
    return out


def _case_breaker_skips_attempts(pkg):
    module, deg = pkg[0], pkg[1]
    deg.configure_degradation(failure_threshold=1, cooldown_s=60.0)
    ledger = module.TenantLedger()
    db = _FakeDb(fail=True)
    rollup = module.TenantUsageRollup(db, ledger, interval_s=60, pending_max=8)
    ledger.add("team:a", prompt_tokens=1)
    out = [_flush(rollup), db.attempts]
    ledger.add("team:a", prompt_tokens=2)
    out += [_flush(rollup), db.attempts, rollup.outage_stats()["pending_windows"]]
    db.fail = False
    out += [_flush(rollup, force=True), rollup.outage_stats()["pending_windows"], list(db.rows)]
    return out


@pytest.mark.parametrize("case", [_case_flush_writes_rows, _case_failure_parks_and_retries,
                                  _case_sustained_outage, _case_breaker_skips_attempts],
                         ids=lambda f: f.__name__[6:])
def test_rollup_case_equal_jax(case, monkeypatch):
    results = []
    for name, pkg in PACKAGES.items():
        with monkeypatch.context() as patch:
            _Clock(patch, pkg[0])
            results.append(case(pkg))
    assert results[1] == results[0]


def _ledger_rows(pkg, monkeypatch):
    """Two windows of adds over a migrated sqlite database, then ``recent``."""
    module, deg, fault_module, db_module, migrations = pkg

    async def run():
        deg.configure_degradation(failure_threshold=3, cooldown_s=0.0)
        db = db_module.Database(":memory:")
        await db.connect()
        await db.migrate(migrations)
        ledger = module.TenantLedger()
        rollup = module.TenantUsageRollup(db, ledger, interval_s=60, pending_max=4)
        ledger.add("team:a", requests=1, prompt_tokens=30, generated_tokens=8,
                   kv_page_seconds=0.1234567)
        ledger.add("user:b", requests=2, prompt_tokens=5, cache_hit_tokens=4)
        out = [await rollup.flush()]
        # the fault point parks the next window; disarmed, it lands as stamped
        plane = fault_module.configure_fault_plane(True)
        plane.arm(fault_module.FaultRule(point="ledger.rollup.flush", kind="error"))
        ledger.add("team:a", requests=1, prompt_tokens=9)
        parked_start = ledger._window_started
        try:
            await rollup.flush()
        except Exception as exc:
            out.append(type(exc).__name__)
        out.append(rollup.outage_stats()["pending_windows"])
        plane.disarm("ledger.rollup.flush")
        fault_module.configure_fault_plane(False)
        out.append(await rollup.flush())
        rows = await rollup.recent(limit=10)
        out.append(any(r["window_start"] == parked_start and r["prompt_tokens"] == 9
                       for r in rows))
        out.append(await db.fetchall("SELECT tenant, window_start, window_end, requests,"
                                     " prompt_tokens, generated_tokens, cache_hit_tokens,"
                                     " kv_page_seconds FROM tenant_usage ORDER BY rowid"))
        out.append(rows)
        out.append(ledger.rollups_written)
        await db.close()
        return out

    _Clock(monkeypatch, module)
    return asyncio.run(run())


def test_rollup_over_sqlite_and_the_fault_point_equal_jax(monkeypatch):
    results = []
    for name, pkg in PACKAGES.items():
        with monkeypatch.context() as patch:
            results.append(_ledger_rows(pkg, patch))
    assert results[1] == results[0]
    flushed, error, parked, rewritten, stamped, table, recent, written = results[1]
    assert (flushed, parked, rewritten, stamped, written) == (2, 1, 1, True, 3)
    assert error == "FaultError"
    assert [r["tenant"] for r in table] == ["team:a", "user:b", "team:a"]
    assert table[0]["kv_page_seconds"] == 0.123457
