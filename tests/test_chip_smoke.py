"""The GPU smoke run's phases and its guard, at tiny sizes on CPU.

On the card, `python chip_smoke.py` runs the same phase functions at the
upstream settings; here each runs on a small mesh so that its control flow,
its entry points and its checks are exercised without a GPU.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_phase0_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.phase0_device()


def test_script_exits_nonzero_without_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "phase 0 failed" in proc.stderr


def _assert_ok(rec):
    assert rec["checks"], rec
    for c in rec["checks"]:
        assert c["ok"], c


def test_phase1_channel_tiny():
    # Re=100: the leading mode of the box is the first shear mode, which a
    # 3x3 order-5 mesh resolves well inside the band
    rec = chip_smoke.phase1_channel(preset=(3, 3, 5, 0.5, 30, 2), re=100.0)
    _assert_ok(rec)
    assert rec["os_leading"] == pytest.approx([-(np.pi / 2) ** 2 / 100.0, 0.0])


def test_phase2_cylinder_tiny():
    # far too coarse and short for the Re=50 oracle: check that the whole
    # pipeline runs and reports finite results
    rec = chip_smoke.phase2_cylinder(preset=(2, 6, 4.0, 3, 1e-2, 30, 10, 1))
    assert rec["newton_converged"]
    assert np.isfinite([rec["mu1_abs"], rec["omega"]]).all()
    assert [c["name"] for c in rec["checks"]] == ["|mu1| - 1.0156", "omega - 0.75"]


def test_phase3_adjoint_identity_tiny():
    rec = chip_smoke.phase3_adjoint(nels=(3, 3, 3), order=4, nsteps=6, reps=1)
    _assert_ok(rec)
    assert rec["dtype"] == "float32"
    assert rec["s_per_step"] > 0 and rec["s_per_step_floor"] > 0


def test_phase4_precision_tiny():
    rec = chip_smoke.phase4_precision(nels=(8, 3), order=5, nsteps=20)
    _assert_ok(rec)
    assert (rec["dtype_32"], rec["dtype_64"]) == ("float32", "float64")


def test_phase5_helmholtz_tiny():
    rec = chip_smoke.phase5_helmholtz(
        shapes={"cylinder": (2, 6, 4.0, 3), "duct": ((2, 2, 2), 3)}, reps=4)
    _assert_ok(rec)
    assert rec["cylinder"]["field_shape"] == [4, 4, 12]
    assert rec["duct"]["s_per_apply"] > 0


def test_check_rejects_nonfinite_and_out_of_band():
    assert chip_smoke._check("x", 1e-5, 1e-4, "")["ok"]
    assert not chip_smoke._check("x", -2e-4, 1e-4, "")["ok"]
    assert not chip_smoke._check("x", np.nan, 1e-4, "")["ok"]
