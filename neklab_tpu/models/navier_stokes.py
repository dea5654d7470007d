"""Incompressible Navier-Stokes time stepper: BDFk/EXTk fractional step.

The framework's `nek_advance` (SURVEY section 2.2, first row). One step:

  1. explicit terms: dealiased convection extrapolated to t^{n+1} (EXTk),
     body forcing (user hook + Boussinesq buoyancy), BDFk mass history;
  2. implicit Helmholtz solve for each velocity component (and each scalar):
     (g0/dt) B u + nu A u = rhs, masked CG with Jacobi preconditioning;
  3. pressure correction: solve E dp = -(g0/dt) (q, div u*), update u and p
     (P(N)/P(N-2), no pressure BCs — see models/stokes.py).

Everything is a pure function of (mesh, state); `advance` jits a ramped
BDF1 -> BDF2 -> BDF3 start followed by a lax.scan over the remaining steps, so
a fixed-horizon integration is ONE compiled XLA program per (mesh, nsteps).

State layout (a pytree; this is also the Krylov vector for the nonlinear
analysis paths): velocity u[ndim, nel, ...], pressure p[nel, (n-2)^d],
scalars theta[nscal, nel, ...], plus BDF/EXT history slots — the analog of the
reference's lagged `v*rst` fields (neklab_vectors.f90:30-35).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Callable

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..mesh.core import SemMesh
from ..ops import sem
from ..utils.pytrees import pytree_dataclass
from . import stokes
from .solvers import linear_solve, local_diagonal

# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    """Static solver configuration (closed over by jit; hashable).

    Mirrors the `.par`-file GENERAL/VELOCITY/PRESSURE/TEMPERATURE tiers plus
    `setup_nek`'s programmatic overrides (SURVEY section 5 config tiers).
    forcing_fn(mesh, t, u, theta) -> [ndim, nel, ...] strong body force.
    source_fn(mesh, t, u, theta) -> [nscal, nel, ...] scalar sources.
    """

    viscosity: float
    dt: float
    torder: int = 3
    nscal: int = 0
    conductivity: tuple = ()
    rho: float = 1.0
    vtol: float = 1e-10
    ptol: float = 1e-9
    ttol: float = 1e-10
    vmaxit: int = 500
    pmaxit: int = 800
    pextrap: int = 1  # pressure treatment: 1 = incremental (p* = p^n),
    # 2 = extrapolated (p* = 2 p^n - p^{n-1}, one more power of dt in the
    # splitting error; Nek plan4-style). Default 1: unconditionally robust,
    # and the cylinder parity oracle (PARITY_r02.json) is met with it.
    forcing_fn: Callable | None = None
    source_fn: Callable | None = None

    def __post_init__(self):
        if self.nscal and len(self.conductivity) != self.nscal:
            raise ValueError("conductivity must have nscal entries")


@pytree_dataclass
class FlowState:
    u: jnp.ndarray  # [ndim, nel, ...]
    p: jnp.ndarray  # [nel, (n-2)^ndim]
    theta: jnp.ndarray  # [nscal, nel, ...]
    ulag: jnp.ndarray  # [torder-1, ndim, nel, ...] velocity history
    nlag: jnp.ndarray  # [torder-1, ndim, nel, ...] advection-term history
    tlag: jnp.ndarray  # [torder-1, nscal, nel, ...]
    ntlag: jnp.ndarray  # [torder-1, nscal, nel, ...]
    plag: jnp.ndarray  # [1, nel, ...2] previous pressure (2nd-order extrapolation)
    time: jnp.ndarray  # scalar


def initial_state(mesh: SemMesh, cfg: FlowConfig, u=None, theta=None, p=None) -> FlowState:
    shape = mesh.bm1.shape
    dtype = mesh.bm1.dtype
    nd, ns, no = mesh.ndim, cfg.nscal, cfg.torder - 1
    z = lambda s: jnp.zeros(s, dtype)
    if u is None:
        u = z((nd,) + shape)
    if theta is None:
        theta = z((ns,) + shape)
    if p is None:
        p = z(mesh.bm2.shape)
    return FlowState(
        u=u,
        p=p,
        theta=theta,
        ulag=z((no, nd) + shape),
        nlag=z((no, nd) + shape),
        tlag=z((no, ns) + shape),
        ntlag=z((no, ns) + shape),
        plag=jnp.stack([p]),
        time=jnp.asarray(0.0, dtype),
    )


# BDFk / EXTk coefficients (gamma0, beta_j for u^{n-j}, alpha_j for N^{n-j})
_BDF = {
    1: (1.0, (1.0, 0.0, 0.0)),
    2: (1.5, (2.0, -0.5, 0.0)),
    3: (11.0 / 6.0, (3.0, -1.5, 1.0 / 3.0)),
}
_EXT = {
    1: (1.0, 0.0, 0.0),
    2: (2.0, -1.0, 0.0),
    3: (3.0, -3.0, 1.0),
}


# ---------------------------------------------------------------------------
# operator helpers
# ---------------------------------------------------------------------------


def helmholtz_diag(mesh: SemMesh, h1, h2, mask) -> jnp.ndarray:
    """Jacobi diagonal of the masked assembled Helmholtz operator, as a
    CONSISTENT local-copies field (the assembled diagonal replicated onto
    every element copy of each shared DOF). `mask` is the local Dirichlet
    mask (mesh.vmask / mesh.tmask)."""
    op_local = lambda u: sem.helmholtz_local(mesh, u, h1, h2)
    dloc = local_diagonal(op_local, mesh.bm1.shape, mesh.bm1.dtype, mesh.ndim)
    d = sem.dssum(mesh, dloc)
    return mask * d + (1.0 - mask)


def helmholtz_solve(mesh, rhs_weak, h1, h2, mask, bc_val, tol, maxiter, diag):
    """Solve the assembled Helmholtz system (h1 A + h2 B) u = rhs with
    u = bc_val on Dirichlet DOFs.

    rhs_weak: unassembled local weak residual (no BC lifting), any leading
    axes (components solved jointly — Nek's `ophinv`). `mask`/`diag` are
    local-copies fields (mesh.vmask / helmholtz_diag output).

    The CG runs in the WEIGHTED LOCAL-COPIES representation: with the
    isometry R = diag(sqrt(vmult)) Q (Q = global-to-local copy map;
    Q^T diag(vmult) Q = I), the operator

        op(y) = R A_masked R^T y + (I - R R^T) y
              = sqw * mask * ( dssum(H_local(mask * t)) - t ) + y,
                t = dssum(sqw * y)

    is Euclidean-symmetric on the WHOLE local space (not just the consistent
    subspace) — required by custom_linear_solve's symmetric transpose rule,
    whose transposed solve feeds arbitrary (inconsistent) cotangent RHSs.
    On the consistent subspace it acts as the assembled masked Helmholtz
    operator; off it, as the identity. This avoids the per-iteration
    unstructured local<->unique-DOF gathers of a global-representation CG —
    the dssum is the cheap structured face exchange on box/annulus meshes.
    Same representation trick as Nek5000's `hmholtz` CG (dssum +
    multiplicity-weighted inner products).
    """
    sqw = jnp.sqrt(mesh.vmult)
    ub = (1.0 - mask) * bc_val

    def op(y):
        t = sem.dssum(mesh, sqw * y)
        hv = sem.dssum(mesh, sem.helmholtz_local(mesh, mask * t, h1, h2))
        return sqw * (mask * (hv - t)) + y

    b = mask * sqw * sem.dssum(mesh, rhs_weak - sem.helmholtz_local(mesh, ub, h1, h2))
    precond = lambda r: r / diag
    y = linear_solve(op, b, precond=precond, tol=tol, maxiter=maxiter)
    return ub + mask * (y / sqw)


# ---------------------------------------------------------------------------
# cross-solve solution recycling (Nek5000 residual projection, param(93-95))
# ---------------------------------------------------------------------------


def init_projection_basis(mesh: SemMesh, k: int):
    """Empty rolling E-solution-recycling basis: (X, AX, count) with X the
    A-orthonormal previous solutions and AX ~= A X (stored, never recomputed:
    A x_i is the solve's own RHS at convergence — Nek5000's projection
    scheme, param(93-95) semantics). Zero slots contribute nothing."""
    shape = (k,) + mesh.bm2.shape
    z = jnp.zeros(shape, mesh.bm2.dtype)
    return (z, jnp.zeros_like(z), jnp.zeros((), jnp.int32))


def _basis_project(basis, rhs):
    """xbar, rhs' = rhs - A xbar with xbar the A-orthogonal projection of the
    solution onto span(X): alpha_i = <x_i, rhs> (= <x_i, A x_true>). The
    basis enters through stop_gradient so the rhs -> (xbar, rhs') map is
    structurally LINEAR — linear_transpose'able programs stay transposable,
    and since the downstream solve is exact (custom_linear_solve semantics),
    the overall map is A^{-1} rhs for ANY basis value."""
    X, AX, _ = basis
    Xc = lax.stop_gradient(X)
    AXc = lax.stop_gradient(AX)
    alpha = jnp.einsum("k...,...->k", Xc, rhs, precision="highest")
    xbar = jnp.einsum("k,k...->...", alpha, Xc, precision="highest")
    return xbar, rhs - jnp.einsum("k,k...->...", alpha, AXc, precision="highest")


def _basis_update(basis, delta, adelta, rtol):
    """Append the new solution increment (A-Gram-Schmidt against the current
    slots, rolling replacement). `adelta` is the solve's RHS, which equals
    A delta only to the solver's ABSOLUTE residual tolerance `rtol` — so a
    tiny increment's A-norm estimate is pure noise, and normalizing it
    poisons the basis (norms ~1e8 then NaN observed). The update is SKIPPED
    (old slots kept, count unchanged) unless the A-norm^2 dominates the
    residual-noise bound ~ ||d|| * rtol. NOTE: makes the carried basis a
    NONLINEAR function of the data — callers on transposable paths must keep
    the basis OUT of the program (recycle=0)."""
    X, AX, count = basis
    k = X.shape[0]
    delta = lax.stop_gradient(delta)
    adelta = lax.stop_gradient(adelta)
    beta = jnp.einsum("k...,...->k", X, adelta, precision="highest")
    d = delta - jnp.einsum("k,k...->...", beta, X, precision="highest")
    ad = adelta - jnp.einsum("k,k...->...", beta, AX, precision="highest")
    nrm2 = jnp.sum(d * ad)
    d2 = jnp.sum(d * d)
    ok = nrm2 > 100.0 * jnp.sqrt(d2) * rtol
    inv = jnp.where(ok, lax.rsqrt(jnp.where(ok, nrm2, 1.0)), 0.0)
    slot = lax.rem(count, jnp.asarray(k, count.dtype))
    X_new = lax.dynamic_update_index_in_dim(X, d * inv, slot, 0)
    AX_new = lax.dynamic_update_index_in_dim(AX, ad * inv, slot, 0)
    X = jnp.where(ok, X_new, X)
    AX = jnp.where(ok, AX_new, AX)
    return (X, AX, count + jnp.asarray(ok, count.dtype))


def make_pressure_solver(mesh: SemMesh, cfg: FlowConfig, dt_over_g0, pc=None):
    """Returns dp = solve(rhs) for the E operator at fixed dt/g0.

    For enclosed flows (pure-Neumann pressure) the constant nullspace is
    projected INSIDE the custom_linear_solve callbacks, so the transposed
    solve (which receives arbitrary cotangent RHSs during
    jax.linear_transpose of a step) also sees a consistent system.
    """
    pure = mesh.p_fixed  # no outflow: E has the constant nullspace
    proj = stokes.project_onto_range if pure else (lambda q: q)

    # exact neighbor-block form of E when the preconditioner carries it
    # (ETwoLevel.eb_w): gather+einsum instead of the matrix-free kernel
    # chain — the chain is kernel-count-bound on unstructured 2-D meshes
    if pc is not None and getattr(pc, "eb_w", None) is not None:
        e_apply = lambda q: pc.e_apply(q, dt_over_g0)
    else:
        e_apply = lambda q: stokes.e_op(mesh, q, dt_over_g0)

    def op(dp):
        return proj(e_apply(proj(dp)))

    if pc is not None:
        precond = lambda r: proj(pc.apply(proj(r)))
    else:
        precond = None

    def inner_solve(matvec, rhs):
        from .solvers import pcg

        return pcg(matvec, proj(rhs), precond=precond, tol=cfg.ptol, maxiter=cfg.pmaxit)

    def solve(rhs, x0=None, basis=None):
        """x0: optional warm-start guess (e.g. the previous step's pressure
        increment — Nek's `prabs`-style temporal extrapolation). Implemented
        as the variable shift dp = x0 + delta, E delta = rhs - E x0, so the
        guess enters custom_linear_solve through the RHS and the map stays
        exactly linear/transposable; cuts E-solve iterations ~35% on smooth
        transients.

        basis: optional (X, AX, count) recycling basis (init_projection_basis).
        The RHS is additionally deflated by the A-orthogonal projection onto
        the span of previous solutions (Nek5000 residual projection,
        param(93-95)) and the updated basis is returned: -> (dp, basis'). The
        basis UPDATE is nonlinear in the data — use only on never-transposed
        programs (nonlinear stepper, direct-only matvecs)."""
        if x0 is not None:
            x0 = proj(x0)
            rhs = rhs - e_apply(x0)
        rhs_p = proj(rhs)
        if basis is not None:
            xbar, rhs_p = _basis_project(basis, rhs_p)
            rhs_p = proj(rhs_p)
        dp = lax.custom_linear_solve(op, rhs_p, solve=inner_solve, symmetric=True)
        if basis is not None:
            basis = _basis_update(basis, dp, rhs_p, cfg.ptol)
            dp = dp + xbar
        if x0 is not None:
            dp = dp + x0
        if pure:
            dp = stokes.remove_pressure_mean(mesh, dp)
        return (dp, basis) if basis is not None else dp

    return solve


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def _explicit_terms(mesh: SemMesh, cfg: FlowConfig, u, theta, t, extra_force=None):
    """Weak-form explicit terms: N_u = -(v, u . grad u) + (v, f);
    N_theta_i = -(q, u . grad theta_i) + (q, s_i)."""
    n_u = -sem.convect_volume_weak(mesh, u, u)
    if cfg.forcing_fn is not None:
        n_u = n_u + mesh.bm1 * cfg.forcing_fn(mesh, t, u, theta)
    if extra_force is not None:
        n_u = n_u + mesh.bm1 * extra_force
    if cfg.nscal:
        n_t = -jnp.stack([sem.convect_weak(mesh, theta[i], u) for i in range(cfg.nscal)])
        if cfg.source_fn is not None:
            n_t = n_t + mesh.bm1 * cfg.source_fn(mesh, t, u, theta)
    else:
        n_t = jnp.zeros_like(theta)
    return n_u, n_t


def step(
    mesh: SemMesh,
    cfg: FlowConfig,
    state: FlowState,
    order: int,
    ub=None,
    tb=None,
    extra_force=None,
    vdiag=None,
    tdiags=None,
    pc_e=None,
    dt=None,
    pbasis=None,
) -> FlowState:
    """One BDF(order)/EXT(order) step of the nonlinear solver.

    dt may be a TRACED scalar (UPO period continuation varies dt at fixed
    nsteps without recompiling); defaults to the static cfg.dt.

    pbasis: optional E-solution recycling basis (init_projection_basis) —
    threaded through and RETURNED alongside the state: -> (state', pbasis')."""
    dt = cfg.dt if dt is None else dt
    g0, betas = _BDF[order]
    alphas = _EXT[order]
    if ub is None:
        ub = jnp.zeros_like(state.u)
    if tb is None:
        tb = jnp.zeros_like(state.theta)

    n_u, n_t = _explicit_terms(mesh, cfg, state.u, state.theta, state.time, extra_force)

    # ---- velocity ----
    # pressure treatment (cfg.pextrap): incremental p* = p^n, or extrapolated
    # p* = 2 p^n - p^{n-1} (one more power of dt in the splitting error)
    if cfg.pextrap >= 2 and order >= 2:
        pstar = 2.0 * state.p - state.plag[0]
    else:
        pstar = state.p
    nstar = alphas[0] * n_u + alphas[1] * state.nlag[0] + alphas[2] * state.nlag[1]
    bsum = betas[0] * state.u + betas[1] * state.ulag[0] + betas[2] * state.ulag[1]
    rhs = (cfg.rho / dt) * mesh.bm1 * bsum + nstar + stokes.grad_weak_t(mesh, pstar)

    h1 = cfg.viscosity
    h2 = cfg.rho * g0 / dt
    if vdiag is None:
        vdiag = helmholtz_diag(mesh, h1, h2, mesh.vmask)
    ustar = helmholtz_solve(mesh, rhs, h1, h2, mesh.vmask, ub, cfg.vtol, cfg.vmaxit, vdiag)

    # ---- pressure correction ----
    # E = div (dt/g0) Binv grad^T already carries the dt/g0 factor, so the
    # consistency condition D(u* + du) = 0 reads E dp = -div u* (dp is then
    # the physical pressure increment).
    dt_over_g0 = dt / (g0 * cfg.rho)
    psolve = make_pressure_solver(mesh, cfg, dt_over_g0, pc=pc_e)
    rhs_p = -stokes.div_weak(mesh, ustar)
    # warm start: previous increment (pextrap=1 only — under extrapolation dp
    # is the second difference, for which p^n - p^{n-1} is a worse guess
    # than zero)
    x0_p = (state.p - state.plag[0]) if cfg.pextrap < 2 else None
    if pbasis is not None:
        dp, pbasis = psolve(rhs_p, x0=x0_p, basis=pbasis)
    else:
        dp = psolve(rhs_p, x0=x0_p)
    du = stokes.pressure_correct_velocity(mesh, dp, dt_over_g0)
    u_new = ustar + du
    p_new = pstar + dp

    # ---- scalars ----
    if cfg.nscal:
        ntstar = alphas[0] * n_t + alphas[1] * state.ntlag[0] + alphas[2] * state.ntlag[1]
        tbsum = betas[0] * state.theta + betas[1] * state.tlag[0] + betas[2] * state.tlag[1]
        comps = []
        for i in range(cfg.nscal):
            rhs_t = (1.0 / dt) * mesh.bm1 * tbsum[i] + ntstar[i]
            k1 = cfg.conductivity[i]
            k2 = g0 / dt
            tdiag = (
                tdiags[i]
                if tdiags is not None
                else helmholtz_diag(mesh, k1, k2, mesh.tmask)
            )
            comps.append(
                helmholtz_solve(mesh, rhs_t, k1, k2, mesh.tmask, tb[i], cfg.ttol, cfg.vmaxit, tdiag)
            )
        theta_new = jnp.stack(comps)
    else:
        theta_new = state.theta

    # ---- shift history ----
    shift = lambda lag, cur: jnp.concatenate([cur[None], lag[:-1]], axis=0)
    out = FlowState(
        u=u_new,
        p=p_new,
        theta=theta_new,
        ulag=shift(state.ulag, state.u),
        nlag=shift(state.nlag, n_u),
        tlag=shift(state.tlag, state.theta),
        ntlag=shift(state.ntlag, n_t),
        plag=jnp.stack([state.p]),
        time=state.time + dt,
    )
    return (out, pbasis) if pbasis is not None else out


# ---------------------------------------------------------------------------
# multi-step advance (one compiled program)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("cfg", "nsteps", "ramp", "recycle"))
def advance(mesh: SemMesh, cfg: FlowConfig, state: FlowState, nsteps: int, ub=None, tb=None, ramp: bool = True, pc_e=None, vdiag=None, tdiags=None, dt=None, recycle: int = 0):
    """Integrate nsteps with a BDF1/2/3 startup ramp (self-starting: the map
    needs no externally supplied history, unlike the reference's
    compute_rst/get_rst lag plumbing — exponential_propagator.f90:109-142 —
    which this design makes unnecessary).

    recycle: if > 0, deflate each step's E solve by an A-orthogonal
    projection onto the last `recycle` solutions (Nek5000 residual
    projection, param(93-95)) carried in the scan. The nonlinear stepper is
    never linear-transposed, so the data-dependent basis is safe here (jvp —
    used by the UPO Newton — differentiates through it fine)."""
    vdiag3 = vdiag if vdiag is not None else helmholtz_diag(
        mesh, cfg.viscosity, cfg.rho * _BDF[min(cfg.torder, 3)][0] / cfg.dt, mesh.vmask
    )
    tdiags3 = tdiags if tdiags is not None else ([
        helmholtz_diag(mesh, cfg.conductivity[i], _BDF[min(cfg.torder, 3)][0] / cfg.dt, mesh.tmask)
        for i in range(cfg.nscal)
    ] or None)

    n_ramp = min(cfg.torder - 1, nsteps) if ramp else 0
    for k in range(n_ramp):
        state = step(mesh, cfg, state, order=k + 1, ub=ub, tb=tb, pc_e=pc_e,
                     vdiag=vdiag3, tdiags=tdiags3, dt=dt)

    remaining = nsteps - n_ramp
    if remaining <= 0:
        return state

    # recycling starts AFTER the ramp: E scales with dt/g0, which changes
    # with the BDF order, so ramp-step solutions pair with a different A and
    # would poison the projection (O(1) solve errors observed)
    pbasis = init_projection_basis(mesh, recycle) if recycle else None

    def body(carry, _):
        s, pb = carry
        out = step(mesh, cfg, s, order=min(cfg.torder, 3), ub=ub, tb=tb, vdiag=vdiag3, tdiags=tdiags3, pc_e=pc_e, dt=dt, pbasis=pb)
        s, pb = out if recycle else (out, None)
        return (s, pb), None

    (state, _), _ = lax.scan(body, (state, pbasis), None, length=remaining)
    return state


def advance_adaptive(
    mesh: SemMesh,
    cfg: FlowConfig,
    state: FlowState,
    endtime: float,
    cfl: float = 0.4,
    ub=None,
    tb=None,
    pc_e=None,
    chunk: int = 25,
    max_growth: float = 1.2,
) -> FlowState:
    """Variable-dt nonlinear advance to `endtime` (DNS spin-up).

    The reference's variable-dt path (setup_nek, neklab_nek_setup.f90:159-191):
    dt is re-derived from the target CFL against the CURRENT velocity field,
    with setdt's <=20% growth clamp per re-derivation; the final chunk lands
    on endtime exactly. dt enters the jitted chunk as a TRACED scalar, so the
    whole run is ONE compiled program per chunk length (no recompiles as dt
    adapts). Notes: (1) the BDF history is carried across dt changes with
    FIXED coefficients (the <=20% growth clamp keeps the local inconsistency
    at O(ddt*dt^2), fine for spin-up; analysis runs use fixed dt); (2) the
    Jacobi diagonals are rebuilt per chunk but any supplied preconditioner
    is reused — solves stay exact (tolerance-based)."""
    from ..utils.timestep import cfl_dt, clamp_cfl

    cfl = clamp_cfl(cfl)
    t = float(state.time)
    dt_old = None
    while t < endtime - 1e-12:
        dt_new = cfl_dt(mesh, np.asarray(state.u), cfl=cfl)
        if dt_old is not None:
            dt_new = min(dt_new, max_growth * dt_old)
        nleft = max(1, math.ceil((endtime - t) / dt_new - 1e-12))
        k = min(chunk, nleft)
        if nleft <= chunk:
            dt_new = (endtime - t) / nleft  # hit endtime exactly
        g0 = _BDF[min(cfg.torder, 3)][0]
        vdiag = helmholtz_diag(mesh, cfg.viscosity, cfg.rho * g0 / dt_new, mesh.vmask)
        tdiags = [
            helmholtz_diag(mesh, cfg.conductivity[i], g0 / dt_new, mesh.tmask)
            for i in range(cfg.nscal)
        ] or None
        state = advance(
            mesh, cfg, state, k, ub=ub, tb=tb, pc_e=pc_e, vdiag=vdiag, tdiags=tdiags,
            ramp=(dt_old is None), dt=jnp.asarray(dt_new, mesh.bm1.dtype),
        )
        dt_old = dt_new
        t = float(state.time)
    return state
