"""Open3D cross-check plumbing (the optional third-party leg).

Open3D is not in this image, so the substantive cross-check
(scripts/open3d_crosscheck.py, mirroring /root/reference/test.cpp:96-126)
runs only where the optional dep exists; here we pin (a) the script skips
cleanly - exit 0, no jax import - when open3d is absent, and (b) the full
check runs when it is present (importorskip'd, so it is a SKIP in CI).
"""
import os
import subprocess
import sys

import pytest

SCRIPT = os.path.join(os.path.dirname(__file__), "..", "scripts",
                      "open3d_crosscheck.py")


def test_skips_cleanly_without_open3d():
    try:
        import open3d  # noqa: F401
        pytest.skip("open3d installed - the skip path is not reachable")
    except ImportError:
        pass
    # the ImportError guard sits before any jax import, so this subprocess
    # is cheap and never touches a device backend
    out = subprocess.run([sys.executable, SCRIPT], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "skipped" in out.stdout


def test_crosscheck_smoke():
    pytest.importorskip("open3d")
    sys.path.insert(0, os.path.dirname(SCRIPT))
    try:
        from open3d_crosscheck import run
    finally:
        sys.path.pop(0)
    assert run(smoke=True)
