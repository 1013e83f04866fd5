"""Checks that need a GPU: the chip smoke (chip_smoke.py) on the card.
They skip on a host without one; run them with `pytest -m gpu tests`."""

import os
import subprocess
import sys

import pytest

from conftest import device_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.gpu
def test_chip_smoke_on_card(gpu_available):
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, env=device_env(),
                       cwd=REPO, timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1].startswith('{"ok": true')
