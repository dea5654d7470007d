"""Unsteady periodic-orbit (UPO) system: unknowns (X, T).

F(X, T) = (Phi_T(X) - X, 0) with the phase condition entering through the
bordered Jacobian:

  J (dx, dT) = ( (dPhi_T/dX) dx - dx + (dPhi/dT) dT,  <dx, f(X)>_B )

Reference parity: `nek_upo_system`/`nek_upo_jacobian` + jac_direct/adjoint_map
(/root/reference/src/systems/periodic_orbit.f90). Departures from it:
  * (dPhi/dX) dx and dPhi/dT come from ONE jax.jvp through the nonlinear
    integration (exact discrete monodromy with co-evolving base flow and
    exact period derivative — the reference needs solve_baseflow=.true.
    co-advance plus a finite-difference f(X(T)) endpoint term);
  * dt is a traced scalar (dt = T / nsteps), so Newton updates of the period
    do NOT trigger recompilation;
  * the adjoint map is the exact bordered transpose.

The phase-condition direction f(X) is computed by the reference's
compute_fdot finite difference (neklab_systems.f90:202-223).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..krylov.linop import LinearOperator, NonlinearSystem
from ..mesh.core import SemMesh
from ..models.linearized import LinConfig
from ..models.navier_stokes import advance, initial_state
from ..ops import sem
from ..utils.timestep import cfl_dt, horizon_steps


class PeriodicOrbitSystem(NonlinearSystem):
    """Vectors: {u, theta, T}."""

    def __init__(
        self,
        mesh: SemMesh,
        cfg: LinConfig,
        t_guess: float,
        ub=None,
        tb=None,
        cfl: float = 0.4,
        nsteps: int | None = None,
        precondition: bool = True,
    ):
        self.mesh = mesh
        self.cfg = cfg
        self.ub = ub
        self.tb = tb
        # one dt-independent preconditioner (see FixedPointSystem note)
        self.pc_e = None
        if precondition:
            from ..models.precond import build_e_preconditioner

            self.pc_e = build_e_preconditioner(mesh, 1.0)
        if nsteps is None:
            # fixed step count from the initial period guess + CFL bound with
            # unit velocity scale; dt tracks T/nsteps thereafter
            dt0 = cfl_dt(mesh, jnp.ones((mesh.ndim,) + mesh.bm1.shape), cfl=cfl)
            _, nsteps = horizon_steps(t_guess, dt0)
        self.nsteps = nsteps

    # Phi as a pure function of (u, theta, T) with T traced via dt = T/nsteps
    def _phi(self, u, theta, T):
        fc = self.cfg.flow
        st = initial_state(self.mesh, fc, u=u, theta=theta)
        out = advance(
            self.mesh, fc, st, self.nsteps, ub=self.ub, tb=self.tb,
            dt=T / self.nsteps, pc_e=self.pc_e,
        )
        return out.u, out.theta

    def advance_map(self, x: dict) -> dict:
        u, theta = self._phi(x["u"], x["theta"], x["T"])
        return {"u": u, "theta": theta, "T": x["T"]}

    def response(self, x: dict) -> dict:
        u, theta = self._phi(x["u"], x["theta"], x["T"])
        return {
            "u": u - x["u"],
            "theta": theta - x["theta"],
            "T": jnp.zeros_like(x["T"]),
        }

    def fdot(self, x: dict) -> dict:
        """compute_fdot: f(X) ~ (Phi_dt(X) - X)/dt, one small nonlinear step."""
        fc = self.cfg.flow
        st = initial_state(self.mesh, fc, u=x["u"], theta=x["theta"])
        dt = x["T"] / self.nsteps
        out = advance(self.mesh, fc, st, 1, ub=self.ub, tb=self.tb, dt=dt,
                      pc_e=self.pc_e)
        return {"u": (out.u - x["u"]) / dt, "theta": (out.theta - x["theta"]) / dt}

    def jacobian(self, x: dict) -> LinearOperator:
        return _UPOJacobian(self, x)


class _UPOJacobian(LinearOperator):
    def __init__(self, system: PeriodicOrbitSystem, x: dict):
        self.s = system
        self.x = x
        self._c = None  # phase direction f(X(0))
        self._b = None  # dPhi/dT at the end point
        self._vjp = None

    def _phase_dir(self):
        if self._c is None:
            self._c = self.s.fdot(self.x)
        return self._c

    def _period_dir(self):
        if self._b is None:
            zeros_u = jnp.zeros_like(self.x["u"])
            zeros_t = jnp.zeros_like(self.x["theta"])
            _, (bu, bt) = jax.jvp(
                self.s._phi,
                (self.x["u"], self.x["theta"], self.x["T"]),
                (zeros_u, zeros_t, jnp.ones_like(self.x["T"])),
            )
            self._b = {"u": bu, "theta": bt}
        return self._b

    def _mass_dot(self, a: dict, b: dict):
        m = self.s.mesh
        return jnp.sum(a["u"] * b["u"] * m.bm1) + jnp.sum(a["theta"] * b["theta"] * m.bm1)

    def matvec(self, dx: dict) -> dict:
        _, (du, dth) = jax.jvp(
            self.s._phi,
            (self.x["u"], self.x["theta"], self.x["T"]),
            (dx["u"], dx["theta"], dx["T"]),
        )
        c = self._phase_dir()
        return {
            "u": du - dx["u"],
            "theta": dth - dx["theta"],
            "T": self._mass_dot(dx, c),
        }

    def rmatvec(self, v: dict) -> dict:
        mesh = self.s.mesh
        if self._vjp is None:
            _, self._vjp = jax.vjp(self.s._phi, self.x["u"], self.x["theta"], self.x["T"])
        # scale-normalized cotangent seed (see make_adjoint_propagator)
        iu, it_ = mesh.bm1 * v["u"], mesh.bm1 * v["theta"]
        nv = jnp.sqrt(jnp.sum(v["u"] ** 2) + jnp.sum(v["theta"] ** 2))
        ni = jnp.sqrt(jnp.sum(iu * iu) + jnp.sum(it_ * it_))
        cs = jnp.where(ni > 0, nv / jnp.maximum(ni, 1e-300), 1.0)
        wu, wt, _ = self._vjp((cs * iu, cs * it_))
        au = mesh.vmask * mesh.binv * sem.dssum(mesh, wu) / cs
        at = mesh.tmask * mesh.binv * sem.dssum(mesh, wt) / cs
        c = self._phase_dir()
        b = self._period_dir()
        return {
            "u": au - v["u"] + v["T"] * c["u"],
            "theta": at - v["theta"] + v["T"] * c["theta"],
            "T": self._mass_dot(b, v),
        }


class MonodromyOperator(LinearOperator):
    """Floquet monodromy M = dPhi_T/dX about a converged orbit (X, T):
    exact discrete linearization with co-evolving base flow via jax.jvp.
    Feed to `eigs` for Floquet multipliers (the cylinder |mu_1| = 1.0156
    oracle, BASELINE.md)."""

    def __init__(self, system: PeriodicOrbitSystem, x: dict):
        self.s = system
        self.x = x

    def matvec(self, dx: dict) -> dict:
        _, (du, dth) = jax.jvp(
            self.s._phi,
            (self.x["u"], self.x["theta"], self.x["T"]),
            (dx["u"], dx["theta"], jnp.zeros_like(self.x["T"])),
        )
        return {"u": du, "theta": dth}

    def rmatvec(self, v: dict) -> dict:
        mesh = self.s.mesh
        _, vjp = jax.vjp(self.s._phi, self.x["u"], self.x["theta"], self.x["T"])
        iu, it_ = mesh.bm1 * v["u"], mesh.bm1 * v["theta"]
        nv = jnp.sqrt(jnp.sum(v["u"] ** 2) + jnp.sum(v["theta"] ** 2))
        ni = jnp.sqrt(jnp.sum(iu * iu) + jnp.sum(it_ * it_))
        cs = jnp.where(ni > 0, nv / jnp.maximum(ni, 1e-300), 1.0)
        wu, wt, _ = vjp((cs * iu, cs * it_))
        return {
            "u": mesh.vmask * mesh.binv * sem.dssum(mesh, wu) / cs,
            "theta": mesh.tmask * mesh.binv * sem.dssum(mesh, wt) / cs,
        }
