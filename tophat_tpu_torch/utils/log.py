# Copy of tophat_tpu/utils/log.py (host code), imports rewritten.
"""Stage journal + logging.

Mirrors the reference's observability contract (SURVEY.md §5): per-run
logs/ directory, every stage appended to logs/run.log with `#>stage:`
markers that double as the resume journal (reference: src/tophat.py:267-270
setRunStage; :209 getResumeStage).
"""

from __future__ import annotations

import os
import sys
import time


STAGES = ["start", "prep_reads", "map_start", "juncs_db", "map_segments",
          "report", "alldone"]


class StageLogger:
    def __init__(self, out_dir: str, argv=None):
        self.logs_dir = os.path.join(out_dir, "logs")
        os.makedirs(self.logs_dir, exist_ok=True)
        self.run_log_path = os.path.join(self.logs_dir, "run.log")
        self.log_path = os.path.join(self.logs_dir, "tophat.log")
        with open(self.run_log_path, "a") as f:
            f.write(f"#>start: tophat_tpu {' '.join(argv or [])}\n")

    def stage(self, name: str) -> None:
        with open(self.run_log_path, "a") as f:
            f.write(f"#>{name}:\n")

    def log(self, msg: str) -> None:
        line = f"[{time.strftime('%Y-%m-%d %H:%M:%S')}] {msg}"
        print(line, file=sys.stderr)
        with open(self.log_path, "a") as f:
            f.write(line + "\n")


def get_resume_stage(out_dir: str):
    """Scan logs/run.log for the last completed stage marker."""
    path = os.path.join(out_dir, "logs", "run.log")
    if not os.path.exists(path):
        return None
    last = None
    with open(path) as f:
        for line in f:
            if line.startswith("#>"):
                last = line[2:].split(":")[0]
    return last
