"""Without a GPU, the on-card entry points refuse to run: chip_smoke.py
and bench.py exit non-zero and print no success line or device number."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("script,args,alone", [
    ("chip_smoke.py", [], False),
    ("chip_smoke.py", ["--four-cards"], False),
    ("chip_smoke.py", [], True),
    ("bench.py", [], False),
])
def test_refuses_to_run_without_gpu(tmp_path, script, args, alone):
    path, cwd = ROOT / script, ROOT
    if alone:
        # a directory holding the script and nothing else of the repo
        path = tmp_path / script
        shutil.copy(ROOT / script, path)
        cwd = tmp_path
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(path), *args], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0, out.stdout[-2000:]
    assert '"ok": true' not in out.stdout
    assert "evals_per_sec" not in out.stdout
