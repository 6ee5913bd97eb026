"""
Crash-tolerant SQLite work queue for photometry tasks.

Behavioral counterpart of reference photometry/taskmanager.py with the same
schema and semantics:

- ``todolist`` consumed by priority; ``diagnostics`` (19 columns) and
  ``photometry_skipped`` tables (taskmanager.py:180-207);
- constraint builder incl. the tmag rule that follows the *primary* target
  for ``tpf:`` secondaries (taskmanager.py:21-86);
- STARTED/ABORT/ERROR rows reset on startup — restart-based recovery
  (taskmanager.py:257-272);
- skip-target arbitration: brightest star in a shared mask wins; secondary
  TPF targets never beat their primary (taskmanager.py:435-532);
- optional fully in-memory operation with periodic atomic backups to disk
  via the sqlite backup API + ``os.replace`` (taskmanager.py:316-341);
- JSON progress summary with EMA(alpha=0.1) timings (taskmanager.py:279-303).

Batch addition: :meth:`get_task_batch` leases a *batch* of compatible
tasks (same sector/camera/ccd/datasource/cadence) so the batched extractor
amortises one device program over hundreds of targets — the single-task API
remains for compatibility and the MPI-style pull loop.

The port's own copy of ``photometry_tpu/taskmanager.py``: the same schema,
so a TODO file is shared by both packages.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import sqlite3
import tempfile
from typing import Optional

import numpy as np

from .core.status import STATUS

logger = logging.getLogger(__name__)

__all__ = ["TaskManager", "build_constraints"]


def build_constraints(priority=None, starid=None, sector=None, cadence=None,
                      camera=None, ccd=None, cbv_area=None, datasource=None,
                      tmag_min=None, tmag_max=None, return_list=False):
    """SQL constraint snippets for todolist queries (joined with AND).

    The tmag limits are applied to the *primary* target for ``tpf:NNN``
    secondaries, so a faint star in a bright star's TPF is still processed
    with the bright primaries (reference taskmanager.py:21-86).
    """
    def _in(col, vals):
        return f"todolist.{col} IN (" + ",".join(str(int(v)) for v in np.atleast_1d(vals)) + ")"

    constraints = []
    if priority is not None:
        constraints.append(_in("priority", priority))
    if starid is not None:
        constraints.append(_in("starid", starid))
    if sector is not None:
        constraints.append(_in("sector", sector))
    if cadence == "ffi":
        constraints.append("todolist.datasource='ffi'")
    elif cadence is not None:
        constraints.append(_in("cadence", cadence))
    if camera is not None:
        constraints.append(_in("camera", camera))
    if ccd is not None:
        constraints.append(_in("ccd", ccd))
    if cbv_area is not None:
        constraints.append(_in("cbv_area", cbv_area))
    if tmag_min is not None or tmag_max is not None:
        lo = -99 if tmag_min is None else tmag_min
        hi = 99 if tmag_max is None else tmag_max
        constraints.append(
            f"((todolist.datasource NOT LIKE 'tpf:%' AND todolist.tmag BETWEEN {lo:f} AND {hi:f}) "
            f"OR (todolist.datasource LIKE 'tpf:%' AND CAST(SUBSTR(todolist.datasource,5) AS INTEGER) IN "
            f"(SELECT DISTINCT starid FROM todolist t2 WHERE t2.datasource='tpf' "
            f"AND t2.tmag BETWEEN {lo:f} AND {hi:f})))")
    if datasource is not None:
        constraints.append("todolist.datasource='ffi'" if datasource == "ffi"
                           else "todolist.datasource!='ffi'")
    if return_list:
        return constraints
    return (" AND " + " AND ".join(constraints)) if constraints else ""


_TASK_COLUMNS = "priority,starid,method,sector,camera,ccd,cadence,datasource,tmag"


class TaskManager:
    """Owner of the todo.sqlite work queue."""

    def __init__(self, todo_file: str, cleanup: bool = False,
                 overwrite: bool = False, cleanup_constraints=None,
                 summary=None, summary_interval: int = 100,
                 load_into_memory: bool = False,
                 backup_interval: Optional[int] = 10000):
        if os.path.isdir(todo_file):
            todo_file = os.path.join(todo_file, "todo.sqlite")
        if not os.path.exists(todo_file):
            raise FileNotFoundError(f"Could not find TODO-file: {todo_file}")
        self.todo_file = os.path.abspath(todo_file)
        self.load_into_memory = load_into_memory
        self.backup_interval = backup_interval
        self.summary_file = os.path.abspath(summary) if summary else None
        self.summary_interval = summary_interval
        self.summary_counter = 0
        self._results_saved_counter = 0

        if load_into_memory:
            self.conn = sqlite3.connect(":memory:")
            with contextlib.closing(
                    sqlite3.connect(f"file:{self.todo_file}?mode=ro", uri=True)) as src:
                src.backup(self.conn)
            journal, sync = "MEMORY", "OFF"
        else:
            self.conn = sqlite3.connect(self.todo_file)
            journal, sync = "TRUNCATE", "NORMAL"
        self.conn.row_factory = sqlite3.Row
        self.cursor = self.conn.cursor()
        self.cursor.execute("PRAGMA foreign_keys=ON;")
        self.cursor.execute("PRAGMA locking_mode=EXCLUSIVE;")
        self.cursor.execute(f"PRAGMA journal_mode={journal};")
        self.cursor.execute(f"PRAGMA synchronous={sync};")
        self.cursor.execute("PRAGMA temp_store=MEMORY;")
        self.conn.commit()

        if overwrite:
            self.cursor.execute("UPDATE todolist SET status=NULL;")
            self.cursor.execute("DROP TABLE IF EXISTS diagnostics;")
            self.cursor.execute("DROP TABLE IF EXISTS photometry_skipped;")
            self.conn.commit()
            cleanup = True

        self.cursor.execute("""CREATE TABLE IF NOT EXISTS diagnostics (
            priority INTEGER PRIMARY KEY ASC NOT NULL,
            lightcurve TEXT,
            method_used TEXT NOT NULL,
            elaptime REAL NOT NULL,
            worker_wait_time REAL,
            mean_flux DOUBLE PRECISION,
            variance DOUBLE PRECISION,
            variability DOUBLE PRECISION,
            rms_hour DOUBLE PRECISION,
            ptp DOUBLE PRECISION,
            pos_row REAL,
            pos_column REAL,
            contamination REAL,
            mask_size INTEGER,
            edge_flux REAL,
            stamp_width INTEGER,
            stamp_height INTEGER,
            stamp_resizes INTEGER,
            errors TEXT,
            FOREIGN KEY (priority) REFERENCES todolist(priority) ON DELETE CASCADE ON UPDATE CASCADE
        );""")
        self.cursor.execute("""CREATE TABLE IF NOT EXISTS photometry_skipped (
            priority INTEGER NOT NULL,
            skipped_by INTEGER NOT NULL,
            FOREIGN KEY (priority) REFERENCES todolist(priority) ON DELETE CASCADE ON UPDATE CASCADE,
            FOREIGN KEY (skipped_by) REFERENCES todolist(priority) ON DELETE RESTRICT ON UPDATE CASCADE
        );""")
        self.cursor.execute("CREATE UNIQUE INDEX IF NOT EXISTS diagnostics_lightcurve_idx ON diagnostics (lightcurve);")
        self.cursor.execute("CREATE INDEX IF NOT EXISTS todolist_datasource_idx ON todolist (datasource);")
        # Batch leasing can replay the same (priority, skipped_by) fact from
        # both sides of a symmetric mask overlap; dedup at the schema level
        # (all inserts use OR IGNORE).  Migrate pre-existing duplicates
        # before the unique index is created:
        self.cursor.execute(
            "DELETE FROM photometry_skipped WHERE rowid NOT IN "
            "(SELECT MIN(rowid) FROM photometry_skipped "
            "GROUP BY priority, skipped_by);")
        self.cursor.execute("CREATE UNIQUE INDEX IF NOT EXISTS photometry_skipped_idx "
                            "ON photometry_skipped (priority, skipped_by);")
        self.conn.commit()

        # Reset STARTED/ABORT/ERROR rows — re-run them this time around:
        constraints = [f"status IN ({STATUS.STARTED.value:d},{STATUS.ABORT.value:d},{STATUS.ERROR.value:d})"]
        if cleanup_constraints:
            if isinstance(cleanup_constraints, dict):
                constraints += build_constraints(**cleanup_constraints, return_list=True)
            else:
                constraints += list(cleanup_constraints)
        cstr = " AND ".join(constraints)
        self.cursor.execute("BEGIN TRANSACTION;")
        self.cursor.execute(
            "DELETE FROM diagnostics WHERE priority IN "
            "(SELECT todolist.priority FROM todolist WHERE " + cstr + ");")
        self.cursor.execute("UPDATE todolist SET status=NULL WHERE " + cstr + ";")
        self.conn.commit()
        self.cursor.execute("ANALYZE;")

        self.summary = {
            "slurm_jobid": os.environ.get("SLURM_JOB_ID"),
            "numtasks": 0, "tasks_run": 0, "last_error": None,
            "mean_elaptime": None, "mean_worker_waittime": None,
        }
        for s in STATUS:
            self.summary[s.name] = 0
        if self.summary_file:
            self.cursor.execute("SELECT status,COUNT(*) AS cnt FROM todolist GROUP BY status;")
            for row in self.cursor.fetchall():
                self.summary["numtasks"] += row["cnt"]
                if row["status"] is not None:
                    self.summary[STATUS(row["status"]).name] = row["cnt"]
            os.makedirs(os.path.dirname(self.summary_file), exist_ok=True)
            self.write_summary()

        if cleanup:
            tmp_iso = self.conn.isolation_level
            try:
                self.conn.isolation_level = None
                self.cursor.execute("VACUUM;")
            finally:
                self.conn.isolation_level = tmp_iso

    # ------------------------------------------------------------------ admin
    def close(self):
        if getattr(self, "conn", None):
            self.backup()
            self.write_summary()
            self.conn.commit()
            self.cursor.close()
            self.conn.close()
            self.conn = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        with contextlib.suppress(Exception):
            self.close()

    def backup(self):
        """Atomically persist the in-memory database to the todo file."""
        self._results_saved_counter = 0
        if not self.load_into_memory or self.conn is None:
            return
        backupfile = tempfile.NamedTemporaryFile(
            dir=os.path.dirname(self.todo_file),
            prefix=os.path.basename(self.todo_file) + "-backup-",
            delete=False).name
        with contextlib.closing(sqlite3.connect(backupfile)) as dest:
            self.conn.backup(dest)
            dest.execute("PRAGMA journal_mode=DELETE;")
            dest.execute("PRAGMA synchronous=NORMAL;")
            dest.commit()
        try:
            os.replace(backupfile, self.todo_file)
        except PermissionError:  # pragma: no cover
            logger.exception("Could not overwrite original file. Backup: %s", backupfile)

    def write_summary(self):
        if self.summary_file:
            try:
                with open(self.summary_file, "w") as fid:
                    json.dump(self.summary, fid)
            except OSError:  # pragma: no cover
                logger.exception("Could not write summary file")

    # ------------------------------------------------------------------ leasing
    def get_number_tasks(self, **kwargs) -> int:
        c = build_constraints(**kwargs)
        row = self.cursor.execute(
            "SELECT COUNT(*) FROM todolist WHERE status IS NULL" + c + ";").fetchone()
        return int(row[0])

    def get_task(self, **kwargs) -> Optional[dict]:
        """Next unprocessed task by ascending priority, or None."""
        c = build_constraints(**kwargs)
        row = self.cursor.execute(
            f"SELECT {_TASK_COLUMNS} FROM todolist WHERE status IS NULL" + c
            + " ORDER BY priority LIMIT 1;").fetchone()
        return dict(row) if row else None

    def get_random_task(self) -> Optional[dict]:
        row = self.cursor.execute(
            f"SELECT {_TASK_COLUMNS} FROM todolist WHERE status IS NULL "
            "ORDER BY RANDOM() LIMIT 1;").fetchone()
        return dict(row) if row else None

    def get_task_batch(self, batch_size: int = 256, **kwargs) -> list:
        """Lease a batch of *compatible* tasks for the batched extractor.

        All returned tasks share (sector, camera, ccd, datasource, cadence)
        — i.e. one SectorContext — taken from the highest-priority pending
        task; up to ``batch_size`` tasks, ordered by priority.
        """
        head = self.get_task(**kwargs)
        if head is None:
            return []
        if head["datasource"] == "tpf":
            # Each TPF *primary* target has its own pixel file (its own data
            # context), so primaries cannot share a batch. Secondary targets
            # ('tpf:NNN') share the primary's file and group by their exact
            # datasource below.
            return [head]
        c = build_constraints(**kwargs)
        rows = self.cursor.execute(
            f"SELECT {_TASK_COLUMNS} FROM todolist WHERE status IS NULL" + c
            + " AND sector=? AND camera=? AND ccd=? AND datasource=? AND cadence=?"
            " ORDER BY priority LIMIT ?;",
            (head["sector"], head["camera"], head["ccd"], head["datasource"],
             head["cadence"], batch_size)).fetchall()
        return [dict(r) for r in rows]

    def start_task(self, taskid: int):
        self.cursor.execute(
            f"UPDATE todolist SET status={STATUS.STARTED.value:d} WHERE priority=?;", [taskid])
        self.conn.commit()
        self.summary["STARTED"] += 1

    def start_tasks(self, taskids):
        self.cursor.executemany(
            f"UPDATE todolist SET status={STATUS.STARTED.value:d} WHERE priority=?;",
            [(int(t),) for t in taskids])
        self.conn.commit()
        self.summary["STARTED"] += len(taskids)

    def release_tasks(self, taskids):
        """Return leased (STARTED) tasks to the queue — used when a worker
        dies mid-batch so another worker can pick its lease up immediately
        (in-run form of the startup STARTED-reset, taskmanager.py:257-272)."""
        rows = [(int(t),) for t in taskids]
        self.cursor.executemany(
            f"UPDATE todolist SET status=NULL WHERE priority=? "
            f"AND status={STATUS.STARTED.value:d};", rows)
        released = max(self.cursor.rowcount, 0)
        self.conn.commit()
        self.summary["STARTED"] = max(self.summary["STARTED"] - released, 0)
        return released

    # ------------------------------------------------------------------ results
    def save_result(self, result: dict):
        """Persist one result: status, skip arbitration, diagnostics row."""
        self.cursor.execute("BEGIN TRANSACTION;")
        try:
            out = self._save_result_in_tx(result)
            self.conn.commit()
        except BaseException:
            self.conn.rollback()
            raise
        self._post_save_accounting(result, *out)

    def _save_result_in_tx(self, result: dict):
        """Transactional body of :meth:`save_result`.

        Runs inside an open transaction owned by the caller; returns
        ``(my_status, additional_skipped, error_msg)`` for the post-commit
        accounting.  Kept separate so :meth:`save_results` can persist a
        whole device batch under ONE commit (one fsync) instead of one per
        target — at drain rates the per-target commit is a measurable
        fraction of the host product path.
        """
        details = result.get("details", {})
        error_msg = list(details.get("errors", []) or [])
        my_status = result["status"]
        if not isinstance(my_status, STATUS):
            my_status = STATUS(my_status)
        stamp = details.get("stamp")
        stamp_width = None if stamp is None else stamp[3] - stamp[2]
        stamp_height = None if stamp is None else stamp[1] - stamp[0]

        additional_skipped = 0
        # Batch leasing can deliver a result for a target that a
        # previously-saved batch-mate's arbitration already demoted to
        # SKIPPED (both were in flight together).  The reference never
        # leases a SKIPPED task again, so its unconditional status
        # write is unreachable there (taskmanager.py:539-541 runs only
        # for tasks that actually started); here the arbitration
        # outcome must win: keep SKIPPED and ignore this result's own
        # skip claims (in the reference's sequential order this target
        # would never have run, so it could not have skipped anyone).
        row = self.cursor.execute(
            "SELECT status FROM todolist WHERE priority=?;",
            (result["priority"],)).fetchone()
        already_skipped = row is not None and row[0] == STATUS.SKIPPED.value
        if already_skipped:
            my_status = STATUS.SKIPPED
            skip_targets = set()
        else:
            skip_targets = set(details.get("skip_targets", []) or [])
        if skip_targets:
            ds = result["datasource"]
            if ds.startswith("tpf:") and int(ds[4:]) in skip_targets:
                # A secondary target overlapping its own primary is
                # always the one to skip:
                primary = int(ds[4:])
                row = self.cursor.execute(
                    "SELECT priority FROM todolist WHERE starid=? AND datasource='tpf' "
                    "AND sector=? AND camera=? AND ccd=? AND cadence=?;",
                    (primary, result["sector"], result["camera"],
                     result["ccd"], result["cadence"])).fetchone()
                my_status = STATUS.SKIPPED
                if row is not None:
                    self.cursor.execute(
                        "INSERT OR IGNORE INTO photometry_skipped (priority,skipped_by) VALUES (?,?);",
                        (result["priority"], row[0]))
                else:
                    error_msg.append(
                        f"TargetNotFoundError: Could not find primary TPF target (TIC {primary:d})")
            else:
                skip_starids = ",".join(str(int(s)) for s in skip_targets)
                if result["datasource"] == "tpf":
                    skip_ds = f"'tpf','tpf:{result['starid']:d}'"
                else:
                    skip_ds = "'" + result["datasource"] + "'"
                rows = self.cursor.execute(
                    f"SELECT priority,tmag FROM todolist WHERE starid IN ({skip_starids}) "
                    f"AND datasource IN ({skip_ds}) AND sector=? AND camera=? AND ccd=? AND cadence=?;",
                    (result["sector"], result["camera"], result["ccd"],
                     result["cadence"])).fetchall()
                if rows:
                    skip_tmags = np.array([r["tmag"] for r in rows])
                    if np.all(result["tmag"] < skip_tmags):
                        # Brightest in the mask -> keep; skip the others.
                        self.cursor.execute(
                            "DELETE FROM photometry_skipped WHERE skipped_by=?;",
                            (result["priority"],))
                        for r in rows:
                            self.cursor.execute(
                                f"UPDATE todolist SET status={STATUS.SKIPPED.value:d} WHERE priority=?;",
                                [r["priority"]])
                            additional_skipped += self.cursor.rowcount
                            self.cursor.execute(
                                "INSERT OR IGNORE INTO photometry_skipped (priority,skipped_by) VALUES (?,?);",
                                (r["priority"], result["priority"]))
                    else:
                        my_status = STATUS.SKIPPED
                        self.cursor.execute(
                            "INSERT OR IGNORE INTO photometry_skipped (priority,skipped_by) VALUES (?,?);",
                            (result["priority"],
                             rows[int(np.argmin(skip_tmags))]["priority"]))

        error_str = None if not error_msg else "\n".join(error_msg)
        self.cursor.execute("UPDATE todolist SET status=? WHERE priority=?;",
                            (my_status.value, result["priority"]))
        pos = details.get("pos_centroid", (None, None))
        self.cursor.execute(
            "INSERT OR REPLACE INTO diagnostics (priority, lightcurve, method_used, "
            "elaptime, worker_wait_time, pos_column, pos_row, mean_flux, variance, "
            "variability, rms_hour, ptp, mask_size, edge_flux, contamination, "
            "stamp_width, stamp_height, stamp_resizes, errors) "
            "VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?);", (
                result["priority"],
                details.get("filepath_lightcurve"),
                result["method_used"],
                result["time"],
                result.get("worker_wait_time"),
                pos[0], pos[1],
                details.get("mean_flux"),
                details.get("variance"),
                details.get("variability"),
                details.get("rms_hour"),
                details.get("ptp"),
                details.get("mask_size"),
                details.get("edge_flux"),
                details.get("contamination"),
                stamp_width, stamp_height,
                details.get("stamp_resizes", 0),
                error_str))
        return my_status, additional_skipped, error_msg

    def _post_save_accounting(self, result: dict, my_status, additional_skipped,
                              error_msg):
        """Post-commit bookkeeping: summary counters, EMA timings, backup."""
        self.summary["tasks_run"] += 1
        self.summary[my_status.name] += 1
        self.summary["STARTED"] -= 1
        self.summary["SKIPPED"] += additional_skipped
        if error_msg:
            self.summary["last_error"] = "\n".join(error_msg)

        # EMA (alpha=0.1) of elapsed/wait times:
        if self.summary["mean_elaptime"] is None:
            self.summary["mean_elaptime"] = result["time"]
        else:
            self.summary["mean_elaptime"] += 0.1 * (result["time"] - self.summary["mean_elaptime"])
        wwt = result.get("worker_wait_time")
        if wwt is not None:
            if self.summary["mean_worker_waittime"] is None:
                self.summary["mean_worker_waittime"] = wwt
            else:
                self.summary["mean_worker_waittime"] += 0.1 * (wwt - self.summary["mean_worker_waittime"])

        self.summary_counter += 1
        if self.summary_file and self.summary_counter >= self.summary_interval:
            self.summary_counter = 0
            self.write_summary()

        self._results_saved_counter += 1
        if self.backup_interval is not None and self._results_saved_counter >= self.backup_interval:
            self.backup()

    def save_results(self, results):
        """Persist a batch of results under ONE transaction/commit.

        Arbitration semantics are identical to sequential
        :meth:`save_result` calls — the shared connection sees each
        result's uncommitted status writes, so in-batch skip arbitration
        composes exactly as before; only the fsync is amortised.
        """
        results = list(results)
        if not results:
            return
        self.cursor.execute("BEGIN TRANSACTION;")
        try:
            outs = [self._save_result_in_tx(r) for r in results]
            self.conn.commit()
        except BaseException:
            self.conn.rollback()
            raise
        for r, out in zip(results, outs):
            self._post_save_accounting(r, *out)
