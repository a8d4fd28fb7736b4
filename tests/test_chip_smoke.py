"""chip_smoke.py's contract, checked on the CPU: it refuses anything but
a GPU, its comparison catches one differing line, and its last line has
exactly the agreed shape."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run(script_dir, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, os.path.join(script_dir,
                                                        "chip_smoke.py")],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=120)


def test_refuses_cpu_platform(tmp_path):
    proc = _run(REPO, str(tmp_path))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "needs 1 GPU" in proc.stderr


def test_refuses_without_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(str(tmp_path), str(tmp_path))
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_comparison_catches_one_differing_line():
    want = "".join(f"line {i}\n" for i in range(1000))
    chip_smoke.assert_same(want, want, "same")
    got = want.replace("line 517\n", "line 517 \n")
    with pytest.raises(AssertionError, match="line 518 differs"):
        chip_smoke.assert_same(got, want, "one line")
    with pytest.raises(AssertionError, match="999 lines, want 1000"):
        chip_smoke.assert_same(want[: -len("line 999\n")], want, "short")


class _Dev:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"


def test_result_line_shape():
    line = json.dumps(chip_smoke.result_line([_Dev()]))
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1}}
    four = chip_smoke.result_line([_Dev()] * 4)
    assert four["device"]["count"] == 4 and set(four) == {"ok", "device"}
