"""The port's examples (``examples/*_torch.py``) run on the CPU at their
reduced defaults, each in a subprocess under a 120 s timeout: exit code 0
and the script's own printed check holds (the quickstart's loss falls, the
online-adaptation estimator's lam lands near the worker count of each
phase, the served ids lie in the vocabulary)."""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env() -> dict:
    """The examples' environment: ``src`` on the path and 2 intra-op threads,
    the count the in-process tests pin (``torch.set_num_threads(2)``), so
    that a loaded run does not oversubscribe the CPU."""
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="2")


def _run(name: str) -> str:
    env = _env()
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "examples", name), "--device", "cpu"],
                          env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    return proc.stdout


def test_quickstart_loss_falls():
    out = _run("quickstart_torch.py")
    first, last = map(float, re.search(r"check: loss fell from ([\d.]+) to ([\d.]+): ok",
                                       out).groups())
    assert last < first


def test_online_adaptation_tracks_the_worker_count():
    out = _run("online_adaptation_torch.py")
    m = re.search(r"check: fitted lam \[([\d.]+), ([\d.]+)\] within 30 % of the worker counts "
                  r"\[8, 16\]: ok", out)
    assert m is not None, out[-1000:]
    assert abs(float(m.group(1)) - 8) <= 2.4 and abs(float(m.group(2)) - 16) <= 4.8


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "stablelm-1.6b"])
def test_serve_decode_ids_in_range(arch):
    env = _env()
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "examples", "serve_decode_torch.py"),
                           "--device", "cpu", "--arch", arch], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert re.search(r"check: \(4, 24\) ids in \[0, 512\): ok", proc.stdout)


def test_examples_import_no_jax():
    for name in ("quickstart_torch.py", "online_adaptation_torch.py", "serve_decode_torch.py"):
        src = open(os.path.join(ROOT, "examples", name)).read()
        assert not re.search(r"^\s*(import jax|from jax|from repro\.|import repro\b)", src, re.M)
