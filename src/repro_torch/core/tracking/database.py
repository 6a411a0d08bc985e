"""SQLite experiment tracking — the paper's Fig. 2 schema.

Tables: ``user``, ``experiment``, ``resource``, ``job``.  The database is the
experiment's source of truth: every proposal and every result lands here
*before* it is acted on, which is what makes crash-resume possible
(`Experiment.resume()` replays finished jobs into the proposer and re-queues
the ones that were mid-flight).

WAL mode + a single writer lock keep it safe under the async callback threads.
"""
from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
from typing import Any, Dict, List, Optional

_SCHEMA = """
CREATE TABLE IF NOT EXISTS user (
    user_id   INTEGER PRIMARY KEY AUTOINCREMENT,
    name      TEXT UNIQUE NOT NULL
);
CREATE TABLE IF NOT EXISTS experiment (
    exp_id     INTEGER PRIMARY KEY AUTOINCREMENT,
    user_id    INTEGER REFERENCES user(user_id),
    exp_config TEXT NOT NULL,
    status     TEXT NOT NULL DEFAULT 'created',
    start_time REAL,
    end_time   REAL
);
CREATE TABLE IF NOT EXISTS resource (
    res_id   TEXT NOT NULL,
    exp_id   INTEGER,
    type     TEXT NOT NULL,
    status   TEXT NOT NULL DEFAULT 'free',
    detail   TEXT,
    PRIMARY KEY (res_id, exp_id)
);
CREATE TABLE IF NOT EXISTS job (
    job_id      INTEGER NOT NULL,
    exp_id      INTEGER NOT NULL REFERENCES experiment(exp_id),
    config      TEXT NOT NULL,
    resource_id TEXT,
    status      TEXT NOT NULL,
    score       REAL,
    extra       TEXT,
    error       TEXT,
    start_time  REAL,
    end_time    REAL,
    PRIMARY KEY (job_id, exp_id)
);
CREATE INDEX IF NOT EXISTS idx_job_exp ON job(exp_id, status);
-- write-ahead flight journal: scheduler ledger transitions, lane cursors,
-- snapshots, flight deaths/restarts/quarantines.  Append-only; --resume
-- reads it to reconstruct where every streaming lane was at the crash.
CREATE TABLE IF NOT EXISTS flight_journal (
    seq      INTEGER PRIMARY KEY AUTOINCREMENT,
    exp_id   INTEGER NOT NULL,
    time     REAL NOT NULL,
    kind     TEXT NOT NULL,
    job_id   INTEGER,
    lane     INTEGER,
    step     INTEGER,
    detail   TEXT
);
CREATE INDEX IF NOT EXISTS idx_journal_exp ON flight_journal(exp_id, kind, seq);
-- proposer state written ahead of each proposal batch (RNG bit-generator
-- state + counters), so a resumed proposer continues the exact draw sequence
-- the uninterrupted run would have produced.
CREATE TABLE IF NOT EXISTS proposer_state (
    exp_id  INTEGER PRIMARY KEY,
    state   TEXT NOT NULL,
    time    REAL NOT NULL
);
"""


class TrackingDB:
    def __init__(self, path: str = ":memory:"):
        self.path = path
        if path != ":memory:":
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        self._lock = threading.RLock()
        with self._lock:
            if path != ":memory:":
                self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute("PRAGMA synchronous=NORMAL")
            self._conn.executescript(_SCHEMA)
            self._conn.commit()

    # -- user / experiment ---------------------------------------------------
    def get_or_create_user(self, name: str) -> int:
        with self._lock:
            self._conn.execute("INSERT OR IGNORE INTO user(name) VALUES (?)", (name,))
            self._conn.commit()
            row = self._conn.execute("SELECT user_id FROM user WHERE name=?", (name,)).fetchone()
            return int(row["user_id"])

    def create_experiment(self, exp_config: Dict[str, Any], user: str = "default") -> int:
        uid = self.get_or_create_user(user)
        with self._lock:
            cur = self._conn.execute(
                "INSERT INTO experiment(user_id, exp_config, status, start_time) VALUES (?,?,?,?)",
                (uid, json.dumps(exp_config, sort_keys=True, default=str), "running", time.time()),
            )
            self._conn.commit()
            return int(cur.lastrowid)

    def finish_experiment(self, exp_id: int, status: str = "finished") -> None:
        with self._lock:
            self._conn.execute(
                "UPDATE experiment SET status=?, end_time=? WHERE exp_id=?",
                (status, time.time(), exp_id),
            )
            self._conn.commit()

    def get_experiment(self, exp_id: int) -> Optional[Dict[str, Any]]:
        with self._lock:
            row = self._conn.execute(
                "SELECT * FROM experiment WHERE exp_id=?", (exp_id,)
            ).fetchone()
        if row is None:
            return None
        d = dict(row)
        d["exp_config"] = json.loads(d["exp_config"])
        return d

    def latest_experiment_id(self) -> Optional[int]:
        with self._lock:
            row = self._conn.execute("SELECT MAX(exp_id) AS m FROM experiment").fetchone()
        return None if row is None or row["m"] is None else int(row["m"])

    # -- resources ------------------------------------------------------------
    def register_resource(self, res_id: str, rtype: str, exp_id: int = 0, detail: str = "") -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO resource(res_id, exp_id, type, status, detail) VALUES (?,?,?,?,?)",
                (str(res_id), exp_id, rtype, "free", detail),
            )
            self._conn.commit()

    def set_resource_status(self, res_id: str, status: str, exp_id: int = 0) -> None:
        with self._lock:
            self._conn.execute(
                "UPDATE resource SET status=? WHERE res_id=? AND exp_id=?",
                (status, str(res_id), exp_id),
            )
            self._conn.commit()

    def list_resources(self, exp_id: int = 0, status: Optional[str] = None) -> List[Dict[str, Any]]:
        q = "SELECT * FROM resource WHERE exp_id=?"
        args: List[Any] = [exp_id]
        if status is not None:
            q += " AND status=?"
            args.append(status)
        with self._lock:
            rows = self._conn.execute(q, args).fetchall()
        return [dict(r) for r in rows]

    # -- jobs ------------------------------------------------------------------
    def record_job_start(self, exp_id: int, job_id: int, config_json: str, resource_id: str) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO job(job_id, exp_id, config, resource_id, status, start_time)"
                " VALUES (?,?,?,?,?,?)",
                (job_id, exp_id, config_json, str(resource_id), "running", time.time()),
            )
            self._conn.commit()

    def record_job_end(
        self,
        exp_id: int,
        job_id: int,
        status: str,
        score: Optional[float],
        extra: Any = None,
        error: Optional[str] = None,
    ) -> None:
        with self._lock:
            self._conn.execute(
                "UPDATE job SET status=?, score=?, extra=?, error=?, end_time=?"
                " WHERE job_id=? AND exp_id=?",
                (
                    status,
                    score,
                    None if extra is None else json.dumps(extra, default=str),
                    error,
                    time.time(),
                    job_id,
                    exp_id,
                ),
            )
            self._conn.commit()

    def jobs(self, exp_id: int, status: Optional[str] = None) -> List[Dict[str, Any]]:
        q = "SELECT * FROM job WHERE exp_id=?"
        args: List[Any] = [exp_id]
        if status is not None:
            q += " AND status=?"
            args.append(status)
        q += " ORDER BY job_id"
        with self._lock:
            rows = self._conn.execute(q, args).fetchall()
        out = []
        for r in rows:
            d = dict(r)
            d["config"] = json.loads(d["config"])
            if d.get("extra"):
                try:
                    d["extra"] = json.loads(d["extra"])
                except (TypeError, json.JSONDecodeError):
                    pass
            out.append(d)
        return out

    def best_job(self, exp_id: int, maximize: bool = True) -> Optional[Dict[str, Any]]:
        order = "DESC" if maximize else "ASC"
        with self._lock:
            row = self._conn.execute(
                f"SELECT * FROM job WHERE exp_id=? AND score IS NOT NULL ORDER BY score {order} LIMIT 1",
                (exp_id,),
            ).fetchone()
        if row is None:
            return None
        d = dict(row)
        d["config"] = json.loads(d["config"])
        return d

    # -- flight journal / proposer state (crash-safe streaming) ----------------
    def journal_append(
        self,
        exp_id: int,
        kind: str,
        job_id: Optional[int] = None,
        lane: Optional[int] = None,
        step: Optional[int] = None,
        detail: Any = None,
    ) -> None:
        """Append one write-ahead journal row (lease / snapshot / retire /
        flight_death / restart / quarantine / resume ...)."""
        with self._lock:
            self._conn.execute(
                "INSERT INTO flight_journal(exp_id, time, kind, job_id, lane, step, detail)"
                " VALUES (?,?,?,?,?,?,?)",
                (
                    exp_id, time.time(), kind, job_id, lane, step,
                    None if detail is None else json.dumps(detail, default=str),
                ),
            )
            self._conn.commit()

    def journal_rows(self, exp_id: int, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        q = "SELECT * FROM flight_journal WHERE exp_id=?"
        args: List[Any] = [exp_id]
        if kind is not None:
            q += " AND kind=?"
            args.append(kind)
        q += " ORDER BY seq"
        with self._lock:
            rows = self._conn.execute(q, args).fetchall()
        out = []
        for r in rows:
            d = dict(r)
            if d.get("detail"):
                try:
                    d["detail"] = json.loads(d["detail"])
                except (TypeError, json.JSONDecodeError):
                    pass
            out.append(d)
        return out

    def save_proposer_state(self, exp_id: int, state: Dict[str, Any]) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO proposer_state(exp_id, state, time) VALUES (?,?,?)",
                (exp_id, json.dumps(state, default=str), time.time()),
            )
            self._conn.commit()

    def load_proposer_state(self, exp_id: int) -> Optional[Dict[str, Any]]:
        with self._lock:
            row = self._conn.execute(
                "SELECT state FROM proposer_state WHERE exp_id=?", (exp_id,)
            ).fetchone()
        return None if row is None else json.loads(row["state"])

    def close(self) -> None:
        with self._lock:
            self._conn.close()


class FlightJournal:
    """Thin per-experiment adapter over the ``flight_journal`` table.

    The Experiment wires one of these onto any target / resource manager that
    exposes a ``journal`` attribute, so the streaming engine and the flight
    supervisor append ledger rows without holding an ``exp_id`` themselves.
    Appends are swallowed-on-error by design: journaling must never take down
    a healthy flight (the journal improves recovery, it is not the data path).
    """

    def __init__(self, db: TrackingDB, exp_id: int):
        self.db = db
        self.exp_id = int(exp_id)

    def append(self, kind: str, job_id: Optional[int] = None,
               lane: Optional[int] = None, step: Optional[int] = None,
               detail: Any = None) -> None:
        try:
            self.db.journal_append(self.exp_id, kind, job_id=job_id,
                                   lane=lane, step=step, detail=detail)
        except Exception:
            pass

    def rows(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        return self.db.journal_rows(self.exp_id, kind=kind)
