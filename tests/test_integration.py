"""End-to-end integration tests (the reference's neklabTests.py analog).

Run the example cases as subprocesses and check physical oracles with
delayed assertions. These are EXPENSIVE (minutes each on a GPU, much longer
on CPU), so — like the reference's opt-in `python neklabTests.py` suite —
they only run when NEKLAB_INTEGRATION is set:

    NEKLAB_INTEGRATION=1 python -m pytest tests/test_integration.py -v
    NEKLAB_INTEGRATION=fine ...   # production-resolution oracle (slow)

Oracle provenance:
  * CylEigsDir: leading Floquet multiplier |mu1| = 1.0156 +- 1e-4 at Re=50
    (reference test/neklabTests.py:43-45). The coarse/medium presets are
    mesh-limited; the delta below widens accordingly and the 'fine' mode
    checks the published tolerance band.
  * Shedding frequency St ~ 0.12-0.13 at Re=50 (omega ~ 0.75).
"""

import os

import pytest

from integration_harness import NeklabTPUTestCase

_MODE = os.environ.get("NEKLAB_INTEGRATION", "")
pytestmark = pytest.mark.skipif(
    not _MODE, reason="integration suite is opt-in: set NEKLAB_INTEGRATION=1"
)


class CylEigsDir(NeklabTPUTestCase):
    """Direct stability of the cylinder wake at Re=50 — the reference's one
    shipped integration test (test/neklabTests.py:16-47)."""

    def test_leading_floquet_multiplier(self):
        if _MODE == "fine":
            preset, delta = "fine", 1e-4  # the published oracle band
        elif _MODE == "medium":
            preset, delta = "medium", 3e-3
        else:
            preset, delta = "coarse", 8e-3  # mesh-limited: |mu1| ~ 1.010
        res = self.run_example(
            "cylinder_stability.py", ["--preset", preset], timeout=6000
        )
        self.assertAlmostEqualDelayed(res.get("mu1_abs"), 1.0156, delta, "|mu1|")
        self.assertAlmostEqualDelayed(res.get("omega"), 0.75, 0.05, "omega")
        self.assertIsNotNullDelayed(res.get("n_matvec"), "matvec count")
        self.assertDelayedFailures()


class CylNewtonRe40(NeklabTPUTestCase):
    """Newton base flow on the shipped Re=40 case: converged with a
    superlinear residual history (reference
    examples/cylinder/newton/Re40_fixed_point, residual_quadratic.png)."""

    def test_newton_quadratic_convergence(self):
        res = self.run_example("cylinder_newton_re40.py", [], timeout=6000)
        self.assertIsNotNullDelayed(res.get("residual_history"), "history")
        if res.get("newton_converged") is not True:
            self._delayed_failures.append(
                f"newton did not converge: |F|={res.get('newton_residual')}")
        hist = res.get("residual_history") or []
        if len(hist) >= 3 and not (hist[-1] < 0.05 * hist[0]):
            self._delayed_failures.append(f"weak contraction: {hist}")
        if res.get("superlinear") is not True:
            self._delayed_failures.append(
                f"contraction not superlinear: ratios={res.get('contraction_ratios')}")
        self.assertDelayedFailures()


class PoiseuilleOS(NeklabTPUTestCase):
    """Orr-Sommerfeld parity at Re=7500, alpha=1 (reference
    examples/poiseuille/stability/direct: kdim=128, nev=20)."""

    def test_orr_sommerfeld_leading_mode(self):
        preset = "fine" if _MODE == "fine" else "medium"
        res = self.run_example(
            "poiseuille_stability.py", ["--preset", preset], timeout=6000
        )
        # sigma1 must match the literature OS eigenvalue for Re=7500, a=1
        self.assertIsNotNullDelayed(res.get("os_match_err"), "OS match error")
        if res.get("os_match_err") is not None and res["os_match_err"] > 5e-3:
            self._delayed_failures.append(
                f"OS eigenvalue mismatch: {res['os_match_err']}")
        self.assertDelayedFailures()


class RayBenCritical(NeklabTPUTestCase):
    """Rayleigh-Benard: supercritical at Ra=1900 and Ra_c bracket near
    Chandrasekhar's 1707.762 (reference examples/rayBen/baseflow/rayBen.par)."""

    def test_critical_rayleigh_number(self):
        res = self.run_example("rayleigh_benard.py", ["--critical"], timeout=6000)
        self.assertIsNotNullDelayed(res.get("sigma"), "sigma(Ra=1900)")
        if res.get("supercritical") is not True:
            self._delayed_failures.append("Ra=1900 not supercritical")
        self.assertAlmostEqualDelayed(res.get("ra_c"), 1707.762, 25.0, "Ra_c")
        self.assertDelayedFailures()


class Thermosyphon(NeklabTPUTestCase):
    """Thermosyphon convecting base state via Newton + its spectrum
    (reference examples/thermosyphon/baseflow)."""

    def test_base_flow_and_spectrum(self):
        res = self.run_example("thermosyphon_baseflow.py", [], timeout=6000)
        if res.get("newton_converged") is not True:
            self._delayed_failures.append(
                f"newton did not converge: |F|={res.get('newton_residual')}")
        self.assertIsNotNullDelayed(res.get("sigma1"), "leading eigenvalue")
        if res.get("max_u") is not None and not res["max_u"] > 1e-3:
            self._delayed_failures.append(
                f"no convective motion: max|u|={res['max_u']}")
        self.assertDelayedFailures()


class PoiseuilleOTDSteady(NeklabTPUTestCase):
    """OTD modes on the frozen Poiseuille base flow (reference
    examples/poiseuille/OTD_steady, poiseuille.usr:128-161): eig(Lr) must
    converge to the analytically known leading rates. The oracle runs at
    Re=500 where the r=2 / rest spectral gap (0.0247) makes t=200 fully
    converged; at the reference condition Re=5000 the gap is 2.2e-4, not
    separable in t=200 for anyone, including the reference."""

    def test_otd_spectrum_matches_leading_modes(self):
        res = self.run_example(
            "poiseuille_otd.py",
            ["--re", "500", "--endtime", "200", "--outdir",
             "artifacts/poiseuille_otd_re500"],
            timeout=6000,
        )
        self.assertIsNotNullDelayed(res.get("match_err"), "match_err")
        if res.get("match_err") is not None and res["match_err"] > 1e-4:
            self._delayed_failures.append(
                f"OTD eig(Lr) mismatch vs leading modes: {res['match_err']}")
        self.assertIsNotNullDelayed(res.get("n_printed"), "Ls/Lr series length")
        self.assertDelayedFailures()
