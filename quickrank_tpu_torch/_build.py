"""Builds the port's native shared libraries into ``quickrank_tpu_torch/build/``.

One rule for every library: compile when the library is missing or older
than any of its sources, write to a temporary name and rename it into place,
so that two processes building at once never load a half-written file.
"""

from __future__ import annotations

import os
import subprocess
from typing import Sequence

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")


def is_stale(lib_path: str, sources: Sequence[str]) -> bool:
    if not os.path.exists(lib_path):
        return True
    built = os.path.getmtime(lib_path)
    return any(os.path.getmtime(s) > built for s in sources)


def compile_library(cmd_prefix: Sequence[str], sources: Sequence[str],
                    lib_path: str) -> str:
    """Run ``cmd_prefix + ['-o', tmp] + sources`` and move the output to
    ``lib_path``.  Returns the compiler's stderr (ptxas statistics for
    nvcc); raises RuntimeError with it when the compiler fails."""
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [*cmd_prefix, "-o", tmp, *sources]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"build of {os.path.basename(lib_path)} failed "
            f"(exit {res.returncode}): {' '.join(cmd)}\n{res.stderr}"
        )
    os.replace(tmp, lib_path)
    return res.stderr
