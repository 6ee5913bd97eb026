"""
Merge a corrections-stage TODO-file back into the photometry TODO-file.

The port's own copy of ``photometry_tpu/todo_merge.py`` (host sqlite; the
same paths, ``file:`` URIs included, so both packages treat a path with
spaces or ``?`` alike).  Reference run_todo_merge.py:62-205: the derived
(corrections) file must describe the same task list (same priorities, star
ids, sectors, cameras, ccds and cbv areas); extra tables from the derived
file are copied over; a ``corr_status`` column is created/updated on the
todolist, invalidated (NULL) for rows whose photometry status or method
changed; downstream diagnostics for invalidated rows are purged.

Implemented with sqlite's Python API (iterdump) instead of shelling out to
the sqlite3 CLI.
"""

from __future__ import annotations

import contextlib
import logging
import os
import shutil
import sqlite3
import tempfile

logger = logging.getLogger(__name__)

__all__ = ["todo_merge"]

_CORE_TABLES = {"todolist", "diagnostics", "photometry_skipped", "datavalidation_raw"}


def todo_merge(fname_todo: str, fname_derived: str, fname_final: str,
               overwrite: bool = False) -> str:
    """Merge ``fname_derived`` into ``fname_todo`` producing ``fname_final``."""
    if os.path.exists(fname_final):
        if overwrite:
            os.remove(fname_final)
        else:
            raise FileExistsError(fname_final)

    fname_derived = os.path.abspath(fname_derived)
    with contextlib.closing(sqlite3.connect(f"file:{fname_derived}?mode=ro", uri=True)) as conn:
        cur = conn.cursor()
        cur.execute("SELECT name FROM sqlite_master WHERE type='table';")
        dump_tables = [r[0] for r in cur]
        cur.execute(f"ATTACH DATABASE '{os.path.abspath(fname_todo)}' AS original;")
        c1 = cur.execute("SELECT COUNT(*) FROM main.todolist;").fetchone()[0]
        c2 = cur.execute("SELECT COUNT(*) FROM original.todolist;").fetchone()[0]
        if c1 != c2:
            raise RuntimeError("The two TODO-files are incompatible")
        bad = cur.execute(
            """SELECT COUNT(*) FROM main.todolist t1
               LEFT JOIN original.todolist t2 ON t1.priority=t2.priority WHERE
               t2.priority IS NULL OR t1.starid != t2.starid
               OR t1.sector != t2.sector OR t1.camera != t2.camera
               OR t1.ccd != t2.ccd OR t1.cbv_area != t2.cbv_area;""").fetchone()[0]
        if bad != 0:
            raise RuntimeError("The two TODO-files are incompatible")
        # Rows whose corrections must be re-run (status/method changed):
        cur.execute(
            """SELECT t1.priority FROM main.todolist t1
               LEFT JOIN original.todolist t2 ON t1.priority=t2.priority WHERE
               (COALESCE(t1.method, t2.method) IS NOT NULL AND t1.method != t2.method)
               OR t2.status IS NULL OR t1.status != t2.status;""")
        invalidate = {row[0] for row in cur}
        cur.execute("SELECT name FROM original.sqlite_master WHERE type='table';")
        existing_tables = [r[0] for r in cur]

    dump_tables = [t for t in dump_tables
                   if t not in _CORE_TABLES and not t.startswith("sqlite_")]

    with tempfile.TemporaryDirectory() as tmpdir:
        combined = os.path.join(tmpdir, "working.sqlite")
        shutil.copy(fname_todo, combined)

        with contextlib.closing(sqlite3.connect(combined)) as conn:
            cur = conn.cursor()
            # Empty leftover tables in the photometry file are replaced:
            for tbl in set(existing_tables) & set(dump_tables):
                n = cur.execute(f"SELECT COUNT(*) FROM {tbl};").fetchone()[0]
                if n == 0:
                    cur.execute(f"DROP TABLE {tbl};")
                    conn.commit()
                else:
                    raise RuntimeError(f"Non-empty table would be overwritten: {tbl}")

            # Copy the derived-only tables (schema + rows) via ATTACH:
            cur.execute(f"ATTACH DATABASE 'file:{fname_derived}?mode=ro' AS derived;")
            for tbl in dump_tables:
                row = cur.execute(
                    "SELECT sql FROM derived.sqlite_master WHERE type='table' AND name=?;",
                    (tbl,)).fetchone()
                if row is None or row[0] is None:
                    continue
                cur.execute(row[0])
                cur.execute(f"INSERT INTO main.{tbl} SELECT * FROM derived.{tbl};")
                conn.commit()
            # Recreate indices of the copied tables:
            for tbl in dump_tables:
                for (sql,) in cur.execute(
                        "SELECT sql FROM derived.sqlite_master WHERE type='index' "
                        "AND tbl_name=? AND sql IS NOT NULL;", (tbl,)).fetchall():
                    with contextlib.suppress(sqlite3.OperationalError):
                        cur.execute(sql)
            conn.commit()

            # corr_status column + transfer, invalidating changed rows:
            cols = [r[1] for r in cur.execute("PRAGMA table_info(todolist);")]
            if "corr_status" not in cols:
                cur.execute("ALTER TABLE todolist ADD COLUMN corr_status INTEGER DEFAULT NULL;")
                conn.commit()
            for priority, corr_status in cur.execute(
                    "SELECT priority, corr_status FROM derived.todolist;").fetchall():
                if priority in invalidate:
                    corr_status = None
                cur.execute("UPDATE main.todolist SET corr_status=? WHERE priority=?;",
                            (corr_status, priority))
            conn.commit()
            cur.execute("CREATE INDEX IF NOT EXISTS corr_status_idx ON todolist (corr_status);")
            if "diagnostics_corr" in dump_tables:
                cur.execute("DELETE FROM diagnostics_corr WHERE priority IN "
                            "(SELECT priority FROM todolist WHERE corr_status IS NULL);")
            conn.commit()
            cur.execute("DETACH DATABASE derived;")
            cur.execute("ANALYZE;")
            conn.commit()
            conn.isolation_level = None
            cur.execute("VACUUM;")
        shutil.move(combined, fname_final)
    logger.info("Merged TODO written: %s", fname_final)
    return fname_final
