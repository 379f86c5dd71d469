"""chip_smoke.py refuses to report a result without a GPU.

On the CPU it must exit non-zero and print no ``"ok": true`` line, both
from the checkout and from a directory that holds the script alone (no
package to import).
"""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_smoke_fails_without_gpu(tmp_path, where):
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(JAX_PLATFORMS="cpu", TMPDIR=str(tmp_path))
    r = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    if where == "checkout":
        assert "JAX found no GPU" in r.stderr, r.stderr[-2000:]
    else:
        assert "ModuleNotFoundError" in r.stderr, r.stderr[-2000:]
