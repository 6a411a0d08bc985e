"""Result visualization (paper §III-C / §IV-D) — terminal/CSV oriented.

The released Auptimizer ships a matplotlib dashboard; in this container the
equivalents are text tables and CSV emitters that the benchmarks print, plus
the raw SQLite tables the user can query directly (the paper's own suggestion).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from .database import TrackingDB


def best_so_far(db: TrackingDB, exp_id: int, maximize: bool = True) -> List[float]:
    """Monotone best-score trace in job-completion order (paper Fig. 5)."""
    rows = [r for r in db.jobs(exp_id, status="finished") if r["score"] is not None]
    rows.sort(key=lambda r: (r["end_time"] or 0.0))
    out: List[float] = []
    cur = None
    for r in rows:
        s = r["score"]
        if cur is None or (s > cur if maximize else s < cur):
            cur = s
        out.append(cur)
    return out


def hyperparameter_table(db: TrackingDB, exp_id: int, names: List[str]) -> List[Dict[str, Any]]:
    """Per-job hyperparameter values + score (paper Fig. 4 raw data)."""
    rows = db.jobs(exp_id, status="finished")
    return [
        {**{n: r["config"].get(n) for n in names}, "score": r["score"], "job_id": r["job_id"]}
        for r in rows
    ]


def summarize_experiment(db: TrackingDB, exp_id: int, maximize: bool = True) -> Dict[str, Any]:
    exp = db.get_experiment(exp_id)
    jobs = db.jobs(exp_id)
    finished = [j for j in jobs if j["status"] == "finished" and j["score"] is not None]
    failed = [j for j in jobs if j["status"] in ("failed", "killed", "lost")]
    best = db.best_job(exp_id, maximize=maximize)
    durations = [
        (j["end_time"] - j["start_time"])
        for j in finished
        if j["end_time"] and j["start_time"]
    ]
    return {
        "exp_id": exp_id,
        "proposer": exp["exp_config"].get("proposer"),
        "n_jobs": len(jobs),
        "n_finished": len(finished),
        "n_failed": len(failed),
        "best_score": None if best is None else best["score"],
        "best_config": None if best is None else best["config"],
        "total_job_time_s": sum(durations),
        "mean_job_time_s": (sum(durations) / len(durations)) if durations else 0.0,
        "wall_time_s": (exp["end_time"] or 0) - (exp["start_time"] or 0),
    }


def format_table(rows: List[Dict[str, Any]], columns: Optional[List[str]] = None) -> str:
    if not rows:
        return "(empty)"
    cols = columns or list(rows[0].keys())
    widths = {c: max(len(str(c)), max(len(f"{r.get(c)}") for r in rows)) for c in cols}
    header = " | ".join(str(c).ljust(widths[c]) for c in cols)
    sep = "-+-".join("-" * widths[c] for c in cols)
    body = "\n".join(" | ".join(f"{r.get(c)}".ljust(widths[c]) for c in cols) for r in rows)
    return f"{header}\n{sep}\n{body}"
