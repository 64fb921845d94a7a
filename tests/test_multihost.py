"""Multi-host runtime rehearsal (SURVEY.md §5.8).

The process-spanning mesh path — jax.distributed.initialize, a global mesh whose
axis crosses process boundaries, collectives riding the distributed
runtime — is exercised for real by spawning TWO localhost processes
(4 virtual CPU devices each -> one 8-device global mesh) and asserting
tiled dense flow, landmark-sharded BA, and distributed quantiles equal
their single-process results. See benchmarks/rehearse_multihost.py for
the checks; this test just drives its launcher.
"""

import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_process_distributed_rehearsal():
    script = os.path.join(REPO, "benchmarks", "rehearse_multihost.py")
    # a fresh interpreter per process: the workers must configure XLA
    # device counts and call jax.distributed.initialize before any
    # backend touch, which this test process has long since done
    out = subprocess.run(
        [sys.executable, script, "--port", "29431"],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=560,
        env={k: v for k, v in os.environ.items() if k != "XLA_FLAGS"},
    )
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    assert "REHEARSAL PASSED" in out.stdout
    for pid in (0, 1):
        assert os.path.exists(
            os.path.join(tempfile.gettempdir(), f"rehearse_multihost_ok_{pid}")
        )
