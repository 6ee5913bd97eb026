"""A todo list in the pipeline's schema (frozen copy of the smoke run's ``write_todo``)."""

import os
import sqlite3

import numpy as np


def write_todo(folder, sids, tmags, camera=1, ccd=1, datasources=None, cadences=None,
               sector=1):
    """todo.sqlite with every task's method NULL and priorities by Tmag
    (stable); FFI targets at 1,800 s unless ``datasources`` and
    ``cadences`` say otherwise, task by task.  Returns its path."""
    n = len(sids)
    datasources = ["ffi"] * n if datasources is None else list(datasources)
    cadences = [1800] * n if cadences is None else list(cadences)
    order = np.argsort(tmags, kind="stable")
    path = os.path.join(folder, "todo.sqlite")
    with sqlite3.connect(path) as conn:
        conn.execute("""CREATE TABLE todolist (
            priority INTEGER PRIMARY KEY ASC NOT NULL, starid INTEGER NOT NULL,
            sector INTEGER NOT NULL, datasource TEXT NOT NULL DEFAULT 'ffi',
            camera INTEGER NOT NULL, ccd INTEGER NOT NULL, cadence INTEGER NOT NULL,
            method TEXT DEFAULT NULL, tmag REAL, status INTEGER DEFAULT NULL,
            cbv_area INTEGER NOT NULL);""")
        conn.executemany(
            "INSERT INTO todolist (priority, starid, sector, camera, ccd, cadence, datasource, "
            "tmag, cbv_area) VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?);",
            [(p + 1, int(sids[i]), sector, camera, ccd, int(cadences[i]), datasources[i],
              float(tmags[i]), camera * 100 + ccd * 10 + 1) for p, i in enumerate(order)])
        conn.execute("CREATE UNIQUE INDEX unique_target_idx ON todolist "
                     "(starid, datasource, sector, camera, ccd, cadence);")
        conn.execute("CREATE INDEX status_idx ON todolist (status);")
    return path
