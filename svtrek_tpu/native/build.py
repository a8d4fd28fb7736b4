"""Build the native shared library: `python -m svtrek_tpu.native.build`."""
from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "svtrek_native.c")
OUT = os.path.join(HERE, "libsvtrek_native.so")


def build(force: bool = False) -> str | None:
    """Compile the library if needed; returns the .so path or None."""
    if not force and os.path.exists(OUT) and (
        os.path.getmtime(OUT) >= os.path.getmtime(SRC)
    ):
        return OUT
    cmd = [
        "cc", "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
        "-o", OUT, SRC, "-lz",
    ]
    # libdeflate decodes BGZF blocks faster than zlib; use it when the
    # dev package is present, else fall back to zlib so the library
    # builds anywhere.
    if os.path.exists("/usr/include/libdeflate.h"):
        cmd[cmd.index(SRC):cmd.index(SRC)] = ["-DSVTREK_HAVE_LIBDEFLATE"]
        cmd.append("-ldeflate")
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except Exception as e:  # compiler missing etc.
        print(f"[svtrek_native] build failed: {e}", file=sys.stderr)
        return None
    if r.returncode != 0:
        print(f"[svtrek_native] build failed:\n{r.stderr}", file=sys.stderr)
        return None
    return OUT


if __name__ == "__main__":
    path = build(force="--force" in sys.argv)
    if path:
        print(f"built {path}")
    else:
        sys.exit(1)
