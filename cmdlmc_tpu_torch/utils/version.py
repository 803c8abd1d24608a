# Copied from cmdlmc_tpu/utils/version.py (kept jax-free so the port never imports the JAX package).
"""Run provenance stamping.

The reference bakes the git commit into the install and echoes it at every run
start (setup.py:99-104, LMC/MDMC.py:21-25). Here the stamp is resolved at
runtime (package version + git hash when running from a checkout)."""

from __future__ import annotations

import os
import subprocess

from cmdlmc_tpu_torch import __version__


def version_lines() -> list[str]:
    lines = [f"# cmdlmc_tpu_torch version {__version__}"]
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        out = subprocess.run(
            ["git", "-C", repo, "log", "-1", "--format=%h %cI %s"],
            capture_output=True, text=True, timeout=5,
        )
        if out.returncode == 0 and out.stdout.strip():
            h, date, *msg = out.stdout.strip().split(" ", 2)
            lines.append(f"# Hello. I am from commit {h}")
            lines.append(f"# Commit Date: {date}")
            if msg:
                lines.append(f"# Commit Message: {msg[0]}")
    except (OSError, subprocess.SubprocessError):
        pass
    return lines
