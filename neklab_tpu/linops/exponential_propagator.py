"""The exponential propagator M = exp(tau A): the framework's core matvec.

matvec = integrate the linearized Navier-Stokes equations for horizon tau
(nsteps * dt == tau exactly) about a frozen base flow; rmatvec = the EXACT
discrete adjoint (see models/linearized.py). Eigenvalues of A are recovered
as log(mu)/tau from Ritz values mu of M.

Reference parity: `exptA_linop` + `exptA_matvec`/`exptA_rmatvec`
(/root/reference/src/linops/exponential_propagator.f90:4-107), with:
  * the CFL/dt re-derivation contract of `setup_linear_solver` (cfl=0.5,
    exponential_propagator.f90:12) via utils/timestep.horizon_steps;
  * NO lag-state plumbing (compute_rst/get_rst, :109-142): the propagator is
    self-starting (BDF ramp), so vectors are plain (u, theta) fields and the
    map is exactly linear and exactly transposable.
The temperature variant (exponential_propagator_temp.f90) is subsumed: nscal
is a config knob, theta rides along in the same vector.
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp

from ..krylov.linop import LinearOperator
from ..mesh.core import SemMesh
from ..models.linearized import (
    LinConfig,
    make_adjoint_propagator,
    make_adjoint_propagator_chunked,
    propagate,
    propagate_chunked,
)
from ..models.navier_stokes import FlowConfig
from ..utils.timestep import cfl_dt, horizon_steps

# Horizons beyond this many steps are propagated in bounded-size compiled
# chunks: the monolithic scan compiles fine forward, but its linear_transpose
# at O(10^3) steps crashed the earlier accelerator's compiler (the BFS
# tau=18 adjoint at 2611 steps). The thresholds were chosen there and are not
# measured on the H100.
# Chunk composition is exactly equal to the monolithic map (same step
# sequence), and the chain of chunk transposes is its exact adjoint — so the
# switch is purely a compile-size decision.
DEFAULT_CHUNK_THRESHOLD = 1024
DEFAULT_CHUNK = 512


class ExponentialPropagator(LinearOperator):
    """M = exp(tau A) via time integration of the linearized equations."""

    def __init__(
        self,
        mesh: SemMesh,
        cfg: LinConfig,
        base_u,
        base_theta=None,
        tau: float = 1.0,
        cfl: float = 0.5,
        dt: float | None = None,
        precondition: bool = True,
        adjoint_tol_factor: float = 0.1,
        chunk: int | None = None,
        recycle: int = 0,
    ):
        """adjoint_tol_factor: the transposed implicit solves inherit the
        FORWARD program's tolerances (custom_linear_solve re-solves with the
        same closure), and adjoint Ritz values are measurably more sensitive
        to that truncation than direct ones (round-4 cylinder study: the
        remaining adjoint bias tracked the inner tolerance). The adjoint is
        therefore transposed from a forward program whose vtol/ptol are
        scaled by this factor (default 10x tighter; ~1.3x adjoint matvec
        cost). Set to 1.0 for the exact transpose of the forward matvec's
        own program.

        chunk: steps per compiled chunk. None (default) auto-selects: the
        monolithic single-program path for short horizons, DEFAULT_CHUNK-step
        chunks once nsteps exceeds DEFAULT_CHUNK_THRESHOLD (bounds the
        transposed-program size the compiler must handle). 0 forces the
        monolithic path; any positive value forces that chunk size.

        recycle: if > 0, the FORWARD matvec deflates each step's E solve
        against the last `recycle` solutions (Nek5000 residual projection,
        param(93-95)) — same map to solver tolerance, fewer CG iterations.
        rmatvec always transposes the recycle-free program (the basis update
        is not structurally linear). Monolithic path only (chunk == 0)."""
        self.mesh = mesh
        self.base_u = base_u
        self.base_theta = (
            base_theta
            if base_theta is not None
            else jnp.zeros((cfg.nscal,) + mesh.bm1.shape, mesh.bm1.dtype)
        )
        self.tau = float(tau)
        if dt is None:
            from ..utils.timestep import clamp_cfl

            dt = cfl_dt(mesh, base_u, cfl=clamp_cfl(cfl))
        self.dt, self.nsteps = horizon_steps(tau, dt)
        # rebuild the (hashable, static) config with the derived dt
        import dataclasses

        self.cfg = dataclasses.replace(cfg, flow=dataclasses.replace(cfg.flow, dt=self.dt))
        self.pc_e = None
        g0 = 11.0 / 6.0 if cfg.flow.torder >= 3 else (1.5 if cfg.flow.torder == 2 else 1.0)
        if precondition:
            from ..models.precond import build_e_preconditioner

            self.pc_e = build_e_preconditioner(mesh, self.dt / (g0 * cfg.flow.rho))
        from ..models.navier_stokes import helmholtz_diag

        fc = self.cfg.flow
        self.vdiag = helmholtz_diag(mesh, fc.viscosity, fc.rho * g0 / fc.dt, mesh.vmask)
        self.tdiags = [
            helmholtz_diag(mesh, fc.conductivity[i], g0 / fc.dt, mesh.tmask)
            for i in range(fc.nscal)
        ] or None
        import dataclasses as _dc

        f = float(adjoint_tol_factor)
        self.cfg_adj = (
            self.cfg if f == 1.0 else _dc.replace(
                self.cfg,
                flow=_dc.replace(self.cfg.flow, vtol=fc.vtol * f, ptol=fc.ptol * f),
            )
        )
        self._adjoint = None
        if chunk is None:
            self.chunk = DEFAULT_CHUNK if self.nsteps > DEFAULT_CHUNK_THRESHOLD else 0
        else:
            self.chunk = int(chunk)
        self.recycle = int(recycle) if not self.chunk else 0

    def matvec(self, x: dict) -> dict:
        if self.chunk:
            u, theta = propagate_chunked(
                self.mesh, self.cfg, self.base_u, self.base_theta, x["u"], x["theta"],
                self.nsteps, chunk=self.chunk,
                pc_e=self.pc_e, vdiag=self.vdiag, tdiags=self.tdiags,
            )
        else:
            u, theta = propagate(
                self.mesh, self.cfg, self.base_u, self.base_theta, x["u"], x["theta"], self.nsteps,
                pc_e=self.pc_e, vdiag=self.vdiag, tdiags=self.tdiags,
                recycle=self.recycle,
            )
        return {"u": u, "theta": theta}

    def rmatvec(self, x: dict) -> dict:
        if self._adjoint is None:
            if self.chunk:
                self._adjoint = make_adjoint_propagator_chunked(
                    self.mesh, self.cfg_adj, self.base_u, self.base_theta, self.nsteps,
                    chunk=self.chunk,
                    pc_e=self.pc_e, vdiag=self.vdiag, tdiags=self.tdiags,
                )
            else:
                self._adjoint = make_adjoint_propagator(
                    self.mesh, self.cfg_adj, self.base_u, self.base_theta, self.nsteps,
                    pc_e=self.pc_e, vdiag=self.vdiag, tdiags=self.tdiags,
                )
        u, theta = self._adjoint(x["u"], x["theta"])
        return {"u": u, "theta": theta}
