"""Linearized (and discrete-adjoint) Navier-Stokes stepper.

Perturbation evolution about a FROZEN base flow (U, Theta): same BDFk/EXTk
fractional-step as the nonlinear solver with the convection linearized,

    N(u') = -(v, U . grad u') - (v, u' . grad U)  (+ linear coupling forces),

homogeneous Dirichlet BCs (the perturbation masks), and an optional
per-perturbation body force input (the reference's `neklab_forcing` hook,
neklab_nek_forcing.f90:96-114, used by resolvent harmonic forcing and OTD
rank coupling).

Adjoint: instead of hand-coded adjoint kernels (`convop_adj`,
neklab_linops.f90:287-302) the adjoint propagator is the EXACT discrete
adjoint w.r.t. the mass-weighted inner product <u,v> = sum(u v bm1):

    M* v = vmask . Bhat^-1 dssum( M^T (bm1 . v) ),

with M^T obtained from jax.linear_transpose of the jitted forward propagator
(solves transpose through lax.custom_linear_solve). This satisfies
<Mu, v> = <u, M*v> to SOLVER tolerance (the transposed implicit solves
re-solve iteratively at the forward tolerance; f64 tests pin ~1e-10) — the
reference's continuous-adjoint approach carries discretization-level pairing
error instead.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax

from ..mesh.core import SemMesh
from ..ops import sem
from ..utils.pytrees import pytree_dataclass
from . import stokes
from .navier_stokes import (
    _BDF,
    _EXT,
    FlowConfig,
    helmholtz_diag,
    helmholtz_solve,
    make_pressure_solver,
)


@dataclasses.dataclass(frozen=True)
class LinConfig:
    """Linearized-solver configuration. lin_forcing_fn(mesh, u, theta) must be
    LINEAR in (u, theta) — e.g. Boussinesq buoyancy g*beta*theta'."""

    flow: FlowConfig
    lin_forcing_fn: Callable | None = None
    lin_source_fn: Callable | None = None

    @property
    def nscal(self):
        return self.flow.nscal


@pytree_dataclass
class PertState:
    u: jnp.ndarray
    p: jnp.ndarray
    theta: jnp.ndarray
    ulag: jnp.ndarray
    nlag: jnp.ndarray
    tlag: jnp.ndarray
    ntlag: jnp.ndarray
    plag: jnp.ndarray


def pert_initial(mesh: SemMesh, cfg: LinConfig, u, theta=None) -> PertState:
    shape = mesh.bm1.shape
    dtype = mesh.bm1.dtype
    nd, ns, no = mesh.ndim, cfg.nscal, cfg.flow.torder - 1
    z = lambda s: jnp.zeros(s, dtype)
    if theta is None:
        theta = z((ns,) + shape)
    return PertState(
        u=u,
        p=z(mesh.bm2.shape),
        theta=theta,
        ulag=z((no, nd) + shape),
        nlag=z((no, nd) + shape),
        tlag=z((no, ns) + shape),
        ntlag=z((no, ns) + shape),
        plag=z((1,) + mesh.bm2.shape),
    )


def _explicit_lin_map(mesh, cfg: LinConfig, conv_cache, theta_shape):
    """The explicit linearized operator E(u, theta) -> (n_u, n_t) in LOCAL
    WEAK form (convection + linear coupling forces, before dssum)."""

    def emap(u, theta):
        cu, ct = sem.convect_lin_weak(mesh, u, theta if cfg.nscal else None, conv_cache)
        n_u = -cu
        if cfg.lin_forcing_fn is not None:
            n_u = n_u + mesh.bm1 * cfg.lin_forcing_fn(mesh, u, theta)
        if cfg.nscal:
            n_t = -ct
            if cfg.lin_source_fn is not None:
                n_t = n_t + mesh.bm1 * cfg.lin_source_fn(mesh, u, theta)
        else:
            n_t = jnp.zeros(theta_shape, u.dtype)
        return n_u, n_t

    return emap


def adjoint_explicit_lin_map(mesh, cfg: LinConfig, conv_cache, theta_shape, dtype):
    """Exact B-pairing transpose of the explicit weak operator.

    For C0 fields the assembled bilinear form is a(u, v) = sum E(u) . v over
    local copies (E is a weak form), so the adjoint weak form is the plain
    Euclidean transpose of the LOCAL map: E_adj = linear_transpose(E). This
    replaces the reference's hand-coded `convop_adj` kernels
    (/root/reference/src/linops/neklab_linops.f90:287-302) and is exact at
    the discrete level (dealiasing, metric terms, coupling forces included).
    """
    emap = _explicit_lin_map(mesh, cfg, conv_cache, theta_shape)
    shape = mesh.bm1.shape
    u_ex = jax.ShapeDtypeStruct((mesh.ndim,) + shape, dtype)
    t_ex = jax.ShapeDtypeStruct(theta_shape, dtype)
    transpose = jax.linear_transpose(emap, u_ex, t_ex)

    def eadj(v, psi):
        wu, wt = transpose((v, psi))
        return wu, wt

    return eadj


def _lin_terms(mesh, cfg: LinConfig, u, theta, base_u, base_theta, force, source,
               conv_cache=None, emap=None):
    """Weak linearized explicit terms about (base_u, base_theta).

    conv_cache: precomputed frozen-base dealias quantities
    (sem.lin_convect_cache) — supplied by the propagators so the base-flow
    interpolations are not redone every step. emap: override the explicit
    operator (e.g. its adjoint for transposed/adjoint OTD evolution)."""
    if emap is None:
        if conv_cache is None:
            conv_cache = sem.lin_convect_cache(mesh, base_u, base_theta)
        emap = _explicit_lin_map(mesh, cfg, conv_cache, theta.shape)
    n_u, n_t = emap(u, theta)
    if force is not None:
        n_u = n_u + mesh.bm1 * force
    if cfg.nscal and source is not None:
        n_t = n_t + mesh.bm1 * source
    return n_u, n_t


def step_lin(
    mesh: SemMesh,
    cfg: LinConfig,
    state: PertState,
    base_u,
    base_theta,
    order: int,
    force=None,
    source=None,
    vdiag=None,
    tdiags=None,
    pc_e=None,
    dt=None,
    conv_cache=None,
    emap=None,
    pbasis=None,
) -> PertState:
    """One linearized BDF(order)/EXT(order) step (homogeneous BCs).

    emap: explicit-operator override (adjoint_explicit_lin_map for the
    continuous-adjoint evolution used by transposed OTD).

    pbasis: optional E-solution recycling basis — threaded and RETURNED:
    -> (state', pbasis'). The basis update is nonlinear in the data, so this
    path must NOT appear in linear_transpose'd programs (adjoint propagators
    transpose the recycle-free program; both agree to solver tolerance)."""
    fc = cfg.flow
    dt = fc.dt if dt is None else dt
    g0, betas = _BDF[order]
    alphas = _EXT[order]

    n_u, n_t = _lin_terms(mesh, cfg, state.u, state.theta, base_u, base_theta, force, source,
                          conv_cache=conv_cache, emap=emap)

    # pressure treatment mirrors the nonlinear step (cfg.flow.pextrap)
    if fc.pextrap >= 2 and order >= 2:
        pstar = 2.0 * state.p - state.plag[0]
    else:
        pstar = state.p
    nstar = alphas[0] * n_u + alphas[1] * state.nlag[0] + alphas[2] * state.nlag[1]
    bsum = betas[0] * state.u + betas[1] * state.ulag[0] + betas[2] * state.ulag[1]
    rhs = (fc.rho / dt) * mesh.bm1 * bsum + nstar + stokes.grad_weak_t(mesh, pstar)

    h1 = fc.viscosity
    h2 = fc.rho * g0 / dt
    if vdiag is None:
        vdiag = helmholtz_diag(mesh, h1, h2, mesh.vmask)
    zero = jnp.zeros_like(state.u)
    ustar = helmholtz_solve(mesh, rhs, h1, h2, mesh.vmask, zero, fc.vtol, fc.vmaxit, vdiag)

    dt_over_g0 = dt / (g0 * fc.rho)
    psolve = make_pressure_solver(mesh, fc, dt_over_g0, pc=pc_e)
    x0_p = (state.p - state.plag[0]) if fc.pextrap < 2 else None
    if pbasis is not None:
        dp, pbasis = psolve(-stokes.div_weak(mesh, ustar), x0=x0_p, basis=pbasis)
    else:
        dp = psolve(-stokes.div_weak(mesh, ustar), x0=x0_p)
    du = stokes.pressure_correct_velocity(mesh, dp, dt_over_g0)
    u_new = ustar + du
    p_new = pstar + dp

    if cfg.nscal:
        ntstar = alphas[0] * n_t + alphas[1] * state.ntlag[0] + alphas[2] * state.ntlag[1]
        tbsum = betas[0] * state.theta + betas[1] * state.tlag[0] + betas[2] * state.tlag[1]
        comps = []
        for i in range(cfg.nscal):
            rhs_t = (1.0 / dt) * mesh.bm1 * tbsum[i] + ntstar[i]
            k1 = fc.conductivity[i]
            k2 = g0 / dt
            tdiag = tdiags[i] if tdiags is not None else helmholtz_diag(mesh, k1, k2, mesh.tmask)
            zt = jnp.zeros_like(state.theta[i])
            comps.append(
                helmholtz_solve(mesh, rhs_t, k1, k2, mesh.tmask, zt, fc.ttol, fc.vmaxit, tdiag)
            )
        theta_new = jnp.stack(comps)
    else:
        theta_new = state.theta

    shift = lambda lag, cur: jnp.concatenate([cur[None], lag[:-1]], axis=0)
    out = PertState(
        u=u_new,
        p=p_new,
        theta=theta_new,
        ulag=shift(state.ulag, state.u),
        nlag=shift(state.nlag, n_u),
        tlag=shift(state.tlag, state.theta),
        ntlag=shift(state.ntlag, n_t),
        plag=jnp.stack([state.p]),
    )
    return (out, pbasis) if pbasis is not None else out


# ---------------------------------------------------------------------------
# the propagator: (u0, theta0) -> (u(tau), theta(tau))
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("cfg", "nsteps", "recycle"))
def propagate(mesh: SemMesh, cfg: LinConfig, base_u, base_theta, u0, theta0, nsteps: int, pc_e=None, vdiag=None, tdiags=None, recycle: int = 0):
    """Linear map M: (u0, theta0) -> state after nsteps of the linearized
    solver, with a BDF1/2/3 self-starting ramp and zero initial pressure.

    This is the exponential-propagator matvec exp(tau A) (tau = nsteps*dt) —
    /root/reference/src/linops/exponential_propagator.f90:15-60 — as ONE
    compiled XLA program.

    recycle: if > 0, deflate each step's E solve against the last `recycle`
    solutions (Nek5000 residual projection). The output still equals the
    recycle-free map to SOLVER tolerance (only the inner x0 improves), but
    the program is no longer structurally linear — linear_transpose the
    recycle=0 program for the adjoint (make_adjoint_propagator does).
    """
    fc = cfg.flow
    state = pert_initial(mesh, cfg, u0, theta0)
    tmax = min(fc.torder, 3)
    # Jacobi diagonals: precomputed by the caller if possible — tracing the
    # npts-probe construction inside every propagate bloats compile time.
    vdiag3 = vdiag if vdiag is not None else helmholtz_diag(
        mesh, fc.viscosity, fc.rho * _BDF[tmax][0] / fc.dt, mesh.vmask
    )
    tdiags3 = tdiags if tdiags is not None else ([
        helmholtz_diag(mesh, fc.conductivity[i], _BDF[tmax][0] / fc.dt, mesh.tmask)
        for i in range(fc.nscal)
    ] or None)

    # frozen-base dealias quantities: computed ONCE, reused by every step
    ccache = sem.lin_convect_cache(mesh, base_u, base_theta if fc.nscal else None)

    from .navier_stokes import init_projection_basis

    n_ramp = min(fc.torder - 1, nsteps)
    for k in range(n_ramp):
        state = step_lin(mesh, cfg, state, base_u, base_theta, order=k + 1, pc_e=pc_e,
                         vdiag=vdiag3, tdiags=tdiags3, conv_cache=ccache)

    remaining = nsteps - n_ramp
    # recycling starts AFTER the ramp: E scales with dt/g0, which changes
    # with the BDF order (see navier_stokes.advance)
    pbasis = init_projection_basis(mesh, recycle) if recycle else None
    if remaining > 0:

        def body(carry, _):
            s, pb = carry
            out = step_lin(
                mesh, cfg, s, base_u, base_theta, order=tmax, vdiag=vdiag3, tdiags=tdiags3, pc_e=pc_e,
                conv_cache=ccache, pbasis=pb,
            )
            s, pb = out if recycle else (out, None)
            return (s, pb), None

        (state, _), _ = lax.scan(body, (state, pbasis), None, length=remaining)
    return state.u, state.theta


def make_adjoint_propagator(mesh: SemMesh, cfg: LinConfig, base_u, base_theta, nsteps: int, pc_e=None, vdiag=None, tdiags=None):
    """Returns the exact discrete B-adjoint of `propagate` as a function
    (v_u, v_theta) -> (w_u, w_theta): w = vmask Bhat^-1 dssum( M^T (B v) )."""

    def fwd(u0, theta0):
        return propagate(mesh, cfg, base_u, base_theta, u0, theta0, nsteps, pc_e=pc_e,
                         vdiag=vdiag, tdiags=tdiags)

    shape = mesh.bm1.shape
    dtype = mesh.bm1.dtype
    u_ex = jax.ShapeDtypeStruct((mesh.ndim,) + shape, dtype)
    t_ex = jax.ShapeDtypeStruct((cfg.nscal,) + shape, dtype)
    transpose = jax.linear_transpose(fwd, u_ex, t_ex)

    @jax.jit
    def adjoint(v_u, v_theta):
        # SCALE NORMALIZATION (exact by linearity): the cotangent seed
        # bm1 * v is ~2-3 orders of magnitude smaller than the forward's
        # O(1) fields (bm1 carries the element volumes), so the transposed
        # inner solves — which stop at the same ABSOLUTE tolerances as the
        # forward (Nek param(21)/(22) semantics) — would otherwise run at an
        # effective RELATIVE tolerance 1e2-1e3 looser than the forward's.
        # Measured on the cylinder adjoint parity (round 4): that loosening
        # biased |mu1| by +1.6e-4 (out of the 1e-4 oracle band) while the
        # direct run's bias was -1.5e-5. Rescaling the seed to the incoming
        # vector's Euclidean magnitude and undoing it afterwards makes the
        # adjoint solves exactly as accurate as the forward ones.
        nv = jnp.sqrt(jnp.sum(v_u * v_u) + jnp.sum(v_theta * v_theta))
        iu, it_ = mesh.bm1 * v_u, mesh.bm1 * v_theta
        ni = jnp.sqrt(jnp.sum(iu * iu) + jnp.sum(it_ * it_))
        c = jnp.where(ni > 0, nv / jnp.maximum(ni, 1e-300), 1.0)
        wu, wt = transpose((c * iu, c * it_))
        au = mesh.vmask * mesh.binv * sem.dssum(mesh, wu) / c
        at = mesh.tmask * mesh.binv * sem.dssum(mesh, wt) / c
        return au, at

    return adjoint


# ---------------------------------------------------------------------------
# harmonically forced propagation (resolvent evaluate_rhs)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("cfg", "nsteps", "sign"))
def propagate_forced(
    mesh: SemMesh,
    cfg: LinConfig,
    base_u,
    base_theta,
    u0,
    theta0,
    f_re,
    f_im,
    omega,
    nsteps: int,
    t0=0.0,
    sign: int = 1,
    pc_e=None,
    vdiag=None,
    tdiags=None,
    s_re=None,
    s_im=None,
):
    """Integrate the linearized equations with harmonic body forcing
    Re[(f_re + i f_im) e^{i sign omega t}] = f_re cos(s w t) - sign * f_im sin(w t).

    Reference: `evaluate_rhs` of the resolvent operator
    (/root/reference/src/linops/resolvent.f90:80-111): zero or given IC,
    forcing refreshed every step through the forcing hook.
    """
    fc = cfg.flow
    state = pert_initial(mesh, cfg, u0, theta0)
    tmax = min(fc.torder, 3)
    vdiag3 = vdiag if vdiag is not None else helmholtz_diag(
        mesh, fc.viscosity, fc.rho * _BDF[tmax][0] / fc.dt, mesh.vmask
    )
    tdiags3 = tdiags if tdiags is not None else ([
        helmholtz_diag(mesh, fc.conductivity[i], _BDF[tmax][0] / fc.dt, mesh.tmask)
        for i in range(fc.nscal)
    ] or None)

    def force_at(k):
        t = t0 + k * fc.dt
        ph = omega * t
        return jnp.cos(ph) * f_re - sign * jnp.sin(ph) * f_im

    def source_at(k):
        if s_re is None:
            return None
        t = t0 + k * fc.dt
        ph = omega * t
        return jnp.cos(ph) * s_re - sign * jnp.sin(ph) * s_im

    ccache = sem.lin_convect_cache(mesh, base_u, base_theta if fc.nscal else None)

    n_ramp = min(fc.torder - 1, nsteps)
    for k in range(n_ramp):
        state = step_lin(
            mesh, cfg, state, base_u, base_theta, order=k + 1, force=force_at(k),
            source=source_at(k), pc_e=pc_e, vdiag=vdiag3, tdiags=tdiags3, conv_cache=ccache,
        )

    remaining = nsteps - n_ramp
    if remaining > 0:
        # The forcing rides in the scan carry as a phase-rotating complex
        # amplitude z = (f_re + i s f_im) e^{i w t}: force(t) = Re[z].
        # (A loop-invariant linear carry or closure would break scan
        # transposition, which the adjoint resolvent relies on.)
        ph0 = omega * (t0 + n_ramp * fc.dt)
        c0, s0 = jnp.cos(ph0), jnp.sin(ph0)
        dph = omega * fc.dt
        cd, sd = jnp.cos(dph), jnp.sin(dph)

        def rot0(re, im):
            im = sign * im
            return c0 * re - s0 * im, s0 * re + c0 * im

        def rot_step(zr, zi):
            return cd * zr - sd * zi, sd * zr + cd * zi

        zr0, zi0 = rot0(f_re, f_im)
        if s_re is not None and s_re.size:
            wr0, wi0 = rot0(s_re, s_im)
        else:
            wr0 = jnp.zeros_like(state.theta)
            wi0 = jnp.zeros_like(state.theta)

        def body(carry, _):
            st, zr, zi, wr, wi = carry
            source = wr if cfg.nscal else None
            st = step_lin(
                mesh, cfg, st, base_u, base_theta, order=tmax, force=zr,
                source=source, vdiag=vdiag3, tdiags=tdiags3, pc_e=pc_e,
                conv_cache=ccache,
            )
            zr, zi = rot_step(zr, zi)
            wr, wi = rot_step(wr, wi)
            return (st, zr, zi, wr, wi), None

        carry = (state, zr0, zi0, wr0, wi0)
        carry, _ = lax.scan(body, carry, None, length=remaining)
        state = carry[0]
    return state.u, state.theta


# ---------------------------------------------------------------------------
# chunked propagation: bounded-size compiled programs for long horizons
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("cfg", "nsteps", "ramp"))
def propagate_chunk(mesh: SemMesh, cfg: LinConfig, base_u, base_theta,
                    state: PertState, nsteps: int, ramp: bool,
                    pc_e=None, vdiag=None, tdiags=None) -> PertState:
    """nsteps of the linearized solver on a FULL PertState (BDF ramp only
    when `ramp`). Chunking rationale: a single monolithic scan over O(10^3)
    steps compiles fine FORWARD, but its linear_transpose at production
    sizes crashed the earlier accelerator's compiler (the BFS tau=18
    adjoint at 2611 steps; not measured on the H100). Chunks bound the compiled program size; the
    full map is the chunk composition and its adjoint the reversed chain of
    chunk transposes (exactly equal — the map is linear)."""
    fc = cfg.flow
    tmax = min(fc.torder, 3)
    vdiag3 = vdiag if vdiag is not None else helmholtz_diag(
        mesh, fc.viscosity, fc.rho * _BDF[tmax][0] / fc.dt, mesh.vmask
    )
    tdiags3 = tdiags if tdiags is not None else ([
        helmholtz_diag(mesh, fc.conductivity[i], _BDF[tmax][0] / fc.dt, mesh.tmask)
        for i in range(fc.nscal)
    ] or None)
    ccache = sem.lin_convect_cache(mesh, base_u, base_theta if fc.nscal else None)

    n_ramp = min(fc.torder - 1, nsteps) if ramp else 0
    for k in range(n_ramp):
        state = step_lin(mesh, cfg, state, base_u, base_theta, order=k + 1,
                         pc_e=pc_e, vdiag=vdiag3, tdiags=tdiags3, conv_cache=ccache)
    remaining = nsteps - n_ramp
    if remaining > 0:
        def body(st, _):
            st = step_lin(mesh, cfg, st, base_u, base_theta, order=tmax,
                          vdiag=vdiag3, tdiags=tdiags3, pc_e=pc_e,
                          conv_cache=ccache)
            return st, None

        state, _ = lax.scan(body, state, None, length=remaining)
    return state


def _chunk_plan(nsteps: int, chunk: int) -> list:
    """[(len, ramp)] chunks: first carries the ramp; at most 3 distinct
    (len, ramp) signatures => at most 3 compiled programs each direction."""
    plan = []
    done = 0
    while done < nsteps:
        k = min(chunk, nsteps - done)
        plan.append((k, done == 0))
        done += k
    # merge a short trailing remainder into at most one distinct extra size
    return plan


def propagate_chunked(mesh: SemMesh, cfg: LinConfig, base_u, base_theta,
                      u0, theta0, nsteps: int, chunk: int = 512,
                      pc_e=None, vdiag=None, tdiags=None):
    """Chunk-composed equivalent of `propagate` (bitwise-equal up to reorder
    of identical programs)."""
    state = pert_initial(mesh, cfg, u0, theta0)
    for k, ramp in _chunk_plan(nsteps, chunk):
        state = propagate_chunk(mesh, cfg, base_u, base_theta, state, k, ramp,
                                pc_e=pc_e, vdiag=vdiag, tdiags=tdiags)
    return state.u, state.theta


def make_adjoint_propagator_chunked(mesh: SemMesh, cfg: LinConfig, base_u,
                                    base_theta, nsteps: int, chunk: int = 512,
                                    pc_e=None, vdiag=None, tdiags=None):
    """Exact discrete B-adjoint of `propagate_chunked`: the reversed chain of
    per-chunk linear transposes (same scale normalization as
    make_adjoint_propagator). Compiles at most 3 transposed chunk programs
    regardless of nsteps."""
    shape = mesh.bm1.shape
    dtype = mesh.bm1.dtype
    nd, ns, no = mesh.ndim, cfg.nscal, cfg.flow.torder - 1
    sds = lambda sh: jax.ShapeDtypeStruct(sh, dtype)
    state_ex = PertState(
        u=sds((nd,) + shape), p=sds(mesh.bm2.shape),
        theta=sds((ns,) + shape),
        ulag=sds((no, nd) + shape), nlag=sds((no, nd) + shape),
        tlag=sds((no, ns) + shape), ntlag=sds((no, ns) + shape),
        plag=sds((1,) + mesh.bm2.shape),
    )
    plan = _chunk_plan(nsteps, chunk)
    transposes = {}
    for k, ramp in plan:
        if (k, ramp) not in transposes:
            fn = lambda st, _k=k, _r=ramp: propagate_chunk(
                mesh, cfg, base_u, base_theta, st, _k, _r,
                pc_e=pc_e, vdiag=vdiag, tdiags=tdiags)
            # jit the transpose: linear_transpose alone re-interprets the
            # chunk jaxpr (a k-step scan body) in Python on EVERY call —
            # measured ~10s/chunk/call on the BFS tau=18 adjoint (the r5
            # production run crawled at ~470 s/iteration before this). Under
            # jit it traces once; the compiled program is one transposed
            # k-step scan — exactly the bounded size chunking exists for.
            transposes[(k, ramp)] = jax.jit(jax.linear_transpose(fn, state_ex))

    zeros_state = jax.tree_util.tree_map(
        lambda l: jnp.zeros(l.shape, l.dtype), state_ex)

    def adjoint(v_u, v_theta):
        # scale normalization: see make_adjoint_propagator
        nv = jnp.sqrt(jnp.sum(v_u * v_u) + jnp.sum(v_theta * v_theta))
        iu, it_ = mesh.bm1 * v_u, mesh.bm1 * v_theta
        ni = jnp.sqrt(jnp.sum(iu * iu) + jnp.sum(it_ * it_))
        c = jnp.where(ni > 0, nv / jnp.maximum(ni, 1e-300), 1.0)
        ct = dataclasses.replace(zeros_state, u=c * iu, theta=c * it_)
        for k, ramp in reversed(plan):
            (ct,) = transposes[(k, ramp)](ct)
        # transpose of pert_initial's embedding: keep the u/theta cotangents
        au = mesh.vmask * mesh.binv * sem.dssum(mesh, ct.u) / c
        at = mesh.tmask * mesh.binv * sem.dssum(mesh, ct.theta) / c
        return au, at

    return adjoint
