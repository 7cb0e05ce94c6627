"""Run provenance: run_config.json with argv, args, versions, devices and git
state (port of utils/run_config.py), and the copy of a run's summary into
docs/results/.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from typing import Any, Dict, Optional

REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _git_state(repo_dir: Optional[str] = None) -> Dict[str, Any]:
    repo_dir = repo_dir or REPO_DIR
    try:
        run = lambda *cmd: subprocess.run(cmd, cwd=repo_dir, capture_output=True, text=True,
                                          timeout=5).stdout.strip()
        return {"commit": run("git", "rev-parse", "HEAD") or None,
                "dirty": bool(run("git", "status", "--porcelain"))}
    except (OSError, subprocess.SubprocessError):
        return {"commit": None, "dirty": None}


def write_run_config(out_dir: str, args: Any, extra: Optional[Dict] = None) -> str:
    """Write out_dir/run_config.json; returns its path."""
    import torch

    os.makedirs(out_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    payload = {
        "argv": sys.argv,
        "args": vars(args) if hasattr(args, "__dict__") else dict(args),
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        "devices": ([torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
                    if cuda else ["cpu"]),
        "git": _git_state(),
    }
    if extra:
        payload.update(extra)
    path = os.path.join(out_dir, "run_config.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, default=str)
    return path


def archive_evidence(out_dir: str, files=("summary.json", "run_config.json"),
                     repo_dir: Optional[str] = None) -> Optional[str]:
    """Copy a run's summary and provenance into docs/results/<run>/, <run>
    being out_dir relative to the repo's runs/ with separators flattened
    (runs/a/b -> docs/results/a__b), so that quality claims stay re-derivable
    after runs/ is wiped. Skipped under ID_TPU_NO_EVIDENCE=1, under pytest
    and for out_dirs outside runs/, unless ID_TPU_FORCE_EVIDENCE=1. Returns
    the destination, or None when nothing was copied."""
    if os.environ.get("ID_TPU_NO_EVIDENCE"):
        return None
    repo_dir = repo_dir or REPO_DIR
    out_abs = os.path.abspath(out_dir)
    rel = os.path.relpath(out_abs, os.path.join(repo_dir, "runs"))
    if not os.environ.get("ID_TPU_FORCE_EVIDENCE"):
        if os.environ.get("PYTEST_CURRENT_TEST") or rel.startswith(".."):
            return None
    if rel.startswith(".."):
        rel = os.path.basename(out_abs)
    dest = os.path.join(repo_dir, "docs", "results", rel.replace(os.sep, "__"))
    os.makedirs(dest, exist_ok=True)
    copied = False
    for name in files:
        src = os.path.join(out_dir, name)
        if os.path.isfile(src):
            shutil.copyfile(src, os.path.join(dest, name))
            copied = True
    return dest if copied else None
