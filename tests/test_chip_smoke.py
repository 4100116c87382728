"""chip_smoke.py refuses to run without a GPU and without the package."""
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))


def test_fails_on_cpu():
    out = _run(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
