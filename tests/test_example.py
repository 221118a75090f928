"""The committed example must keep executing — it is documentation."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_satellite_beacon_demo_runs_end_to_end():
    """Default arguments: pass prediction, Doppler channel, blind path
    fails at the default SNR, model+stack+AP path decodes the beacon."""
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples",
                                      "satellite_beacon_demo.py")],
        capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "stacked decode : 'CQ PI4THD JO22'" in out.stdout
    assert "known-payload  : track detected" in out.stdout
