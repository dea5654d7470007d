"""Optimally Time-Dependent (OTD) mode evolution.

Co-evolves r orthonormal perturbations with the (optionally unsteady) base
flow; the perturbation index is an embarrassingly parallel batch axis handled
by jax.vmap over the linearized step (SURVEY 2.3: lpert as batch axis).

Per chunk of `orthostep` steps (ONE jitted call):
  1. base flow: nonlinear step (if solve_baseflow) — perturbations linearize
     about the current base each step;
  2. perturbations: vmapped linearized steps with the rank-coupling forcing
     f_i = -sum_j (Lr_ji - Phi_ji) u_j refreshed every step;
  3. orthonormalization of the basis (Gram Cholesky, applied to the FULL
     state pytree incl. pressure/history — the reference's axpby touches the
     rst slots too, real_vectors.f90:125-206);
  4. reduced operator Lr_ij = <u_i, L u_j> with the frozen-LNS apply_L.

Reference parity: `nek_otd` + `otd_analysis`
(/root/reference/src/neklab_otd.f90, neklab_analysis.f90:214-344), including
the Ls.dat / Lr.dat spectra time series and `otd_opts` knobs.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from functools import partial

import jax
import numpy as np
import jax.numpy as jnp

from .mesh.core import SemMesh
from .models import stokes
from .models.linearized import LinConfig, PertState, pert_initial, step_lin
from .models.navier_stokes import _BDF, FlowConfig, FlowState, helmholtz_diag, step
from .ops import sem

logger = logging.getLogger("neklab_tpu.otd")


@dataclasses.dataclass(frozen=True)
class OtdOpts:
    """The reference's otd_opts (neklab_otd.f90:51-72). All knobs are wired:
    startstep (OTD evolution begins at that base step), orthostep
    (re-orthonormalization cadence), printstep (Ls/Lr spectral-analysis
    cadence), iostep (projected-mode outposting cadence), iorststep
    (basis restart-checkpoint cadence), trans (adjoint OTD evolution),
    solve_baseflow (co-evolve the nonlinear base)."""

    r: int = 2  # number of OTD modes (lpert)
    startstep: int = 1
    orthostep: int = 10  # re-orthonormalize every so many steps
    printstep: int = 10  # spectral analysis cadence
    iostep: int = 0  # projected-mode outpost cadence (0 = never)
    iorststep: int = 0  # basis restart-checkpoint cadence (0 = never)
    solve_baseflow: bool = False
    trans: bool = False  # adjoint (transposed) OTD evolution


def apply_l(mesh: SemMesh, cfg: LinConfig, base_u, base_theta, st: PertState,
            trans: bool = False):
    """Frozen-coefficient linearized NS right-hand side L u (strong form):

      L u = Binv vmask dssum( -(v, U.grad u) - (v, u.grad U) - nu (grad v, grad u)
                              + (p, div v) + coupling forces )

    using the perturbation's own pressure (the reference's apply_L/apply_Lv,
    neklab_linops.f90:268-426, with `mappr`-style pressure term).

    trans=True applies the B-adjoint of the convection + coupling part
    (exact discrete transpose via jax.linear_transpose — replaces the
    reference's convop_adj path, neklab_linops.f90:287-302); the viscous term
    is self-adjoint and the pressure term keeps the input's own pressure,
    matching apply_L(trans=.true.).
    """
    from .models.linearized import _explicit_lin_map, adjoint_explicit_lin_map

    fc = cfg.flow
    ccache = sem.lin_convect_cache(mesh, base_u, base_theta if cfg.nscal else None)
    if trans:
        emap = adjoint_explicit_lin_map(mesh, cfg, ccache, st.theta.shape, st.u.dtype)
    else:
        emap = _explicit_lin_map(mesh, cfg, ccache, st.theta.shape)
    n_u, _ = emap(st.u, st.theta)
    visc = -fc.viscosity * jnp.stack([sem.stiffness_local(mesh, st.u[i]) for i in range(mesh.ndim)])
    gp = stokes.grad_weak_t(mesh, st.p)
    return mesh.vmask * mesh.binv * sem.dssum(mesh, n_u + visc + gp)


def _mass_dots(mesh, a, b):
    return jnp.einsum("ic...,jc...->ij", a * mesh.bm1[None, None], b, precision="highest")


def orthonormalize_states(mesh: SemMesh, states: PertState) -> PertState:
    """Cholesky-based orthonormalization of the batch (leading axis r) w.r.t.
    the velocity mass inner product; the whole state pytree is rotated."""
    g = _mass_dots(mesh, states.u, states.u)
    l = jnp.linalg.cholesky(g)
    linv = jax.scipy.linalg.solve_triangular(l, jnp.eye(g.shape[0], dtype=g.dtype), lower=True)
    rotate = lambda leaf: jnp.einsum("ij,j...->i...", linv, leaf, precision="highest")
    return jax.tree_util.tree_map(rotate, states)


@partial(jax.jit, static_argnames=("cfg", "opts", "ksteps", "ramp", "ortho_every"))
def otd_chunk(
    mesh: SemMesh,
    cfg: LinConfig,
    opts: OtdOpts,
    base: FlowState,
    perts: PertState,
    ksteps: int,
    ramp: bool = False,
    ub=None,
    tb=None,
    pc_e=None,
    vdiag=None,
    ortho_every: int = 0,
):
    """Advance base + r perturbations ksteps, orthonormalize, and return the
    reduced operator Lr. One compiled program per chunk. Set ramp=True for
    the FIRST chunk: BDF3 with cold (zero) history slots is violently
    unstable, so the first two steps run at orders 1 and 2.

    ortho_every: re-orthonormalize the basis every so many steps inside the
    chunk (the reference's opts%orthostep cadence); 0 = only at chunk end.
    opts.trans evolves the ADJOINT linearized equations and uses the
    transposed frozen-LNS operator for Lr (neklab_otd.f90:63, apply_adjLNS).
    """
    fc = cfg.flow
    tmax = min(fc.torder, 3)
    g0 = _BDF[tmax][0]
    if vdiag is None:
        vdiag = helmholtz_diag(mesh, fc.viscosity, fc.rho * g0 / fc.dt, mesh.vmask)

    def lu_all(b_u, b_th, ps):
        return jax.vmap(lambda s: apply_l(mesh, cfg, b_u, b_th, s, trans=opts.trans))(ps)

    def emap_for(b_u, b_th):
        if not opts.trans:
            return None
        from .models.linearized import adjoint_explicit_lin_map

        ccache = sem.lin_convect_cache(mesh, b_u, b_th if cfg.nscal else None)
        th_shape = (cfg.nscal,) + mesh.bm1.shape
        return adjoint_explicit_lin_map(mesh, cfg, ccache, th_shape, mesh.bm1.dtype)

    def do_step(b, ps, order):
        lu = lu_all(b.u, b.theta, ps)
        lr = _mass_dots(mesh, ps.u, lu)
        forces = -jnp.einsum("ji,j...->i...", lr, ps.u, precision="highest")
        emap = emap_for(b.u, b.theta)
        step_fn = lambda s, f: step_lin(
            mesh, cfg, s, b.u, b.theta, order=order, force=f, vdiag=vdiag, pc_e=pc_e,
            emap=emap,
        )
        ps = jax.vmap(step_fn)(ps, forces)
        if opts.solve_baseflow:
            b = step(mesh, fc, b, order=order, ub=ub, tb=tb, vdiag=vdiag, pc_e=pc_e)
        return b, ps

    n_ramp = min(tmax - 1, ksteps) if ramp else 0
    for k in range(n_ramp):
        base, perts = do_step(base, perts, k + 1)

    def one_step(carry, _):
        b, ps = carry
        b, ps = do_step(b, ps, tmax)
        return (b, ps), None

    def run_block(b, ps, length):
        (b, ps), _ = jax.lax.scan(one_step, (b, ps), None, length=length)
        return b, ps

    remaining = ksteps - n_ramp
    blk = ortho_every if ortho_every and ortho_every < remaining else remaining
    done = 0
    while done < remaining:
        k = min(blk, remaining - done)
        if k > 0:
            base, perts = run_block(base, perts, k)
        done += k
        if done < remaining:
            perts = orthonormalize_states(mesh, perts)
    perts = orthonormalize_states(mesh, perts)
    lu = lu_all(base.u, base.theta, perts)
    lr = _mass_dots(mesh, perts.u, lu)
    return base, perts, lr


def load_otd_ics(
    mesh: SemMesh,
    cfg: LinConfig,
    paths: list[str],
    r: int | None = None,
    seed: int = 7,
) -> PertState:
    """User-supplied OTD initial conditions from field files — the
    reference's `OTDIC_xx.fld` convention (neklab_otd.f90:118-204,
    n_usrIC > 0 branch): the first len(paths) modes come from the files
    (binary Nek .fld or this framework's .npz), any remaining of the r modes
    are randomized, and the whole basis is orthonormalized."""
    r = r if r is not None else len(paths)
    if len(paths) > r:
        raise ValueError(f"more IC files ({len(paths)}) than modes ({r})")
    us = []
    for p in paths:
        if p.endswith(".npz"):
            with np.load(p) as z:
                u = np.asarray(z["u"])
        else:
            from .utils.fldfile import read_fld

            u = read_fld(p).u
        if u is None or u.shape != (mesh.ndim,) + mesh.bm1.shape:
            raise ValueError(f"IC file {p}: expected velocity shaped "
                             f"{(mesh.ndim,) + mesh.bm1.shape}, got {None if u is None else u.shape}")
        us.append(jnp.asarray(u, mesh.bm1.dtype))
    if len(us) < r:
        key = jax.random.PRNGKey(seed)
        rnd = jax.random.normal(key, (r - len(us), mesh.ndim) + mesh.bm1.shape, mesh.bm1.dtype)
        us.extend(list(rnd))
    u = jnp.stack([mesh.vmask * sem.dsavg(mesh, ui) for ui in us])
    perts = jax.vmap(lambda ui: pert_initial(mesh, cfg, ui))(u)
    return orthonormalize_states(mesh, perts)


@dataclasses.dataclass
class OtdResult:
    base: FlowState
    perts: PertState
    lr_history: list  # (time, Lr) tuples
    eigvals_lr: np.ndarray  # spectrum of the final reduced operator
    eigvals_sym: np.ndarray  # spectrum of its symmetric part


def outpost_otd_modes(
    mesh: SemMesh, perts: PertState, lr: np.ndarray, outdir: str,
    counter: int = 1, case: str = "otd", time: float = 0.0,
) -> list[str]:
    """Project the OTD basis by the (real part of the) Lr eigenvector matrix
    and write one binary Nek field file per mode, prefix 'm01', 'm02', ... —
    the reference's `outpost_OTDmodes` (neklab_otd.f90:267-300)."""
    from .utils.fldfile import write_fld

    w, eigvec = np.linalg.eig(np.asarray(lr))
    order = np.argsort(-w.real, kind="stable")
    ev = np.asarray(eigvec[:, order].real)  # [r (basis), r (mode)]
    u = np.asarray(perts.u)  # [r, ndim, ...]
    p = np.asarray(perts.p)  # [r, ...2]
    modes_u = np.einsum("jr,j...->r...", ev, u)
    modes_p = np.einsum("jr,j...->r...", ev, p)
    os.makedirs(outdir, exist_ok=True)
    paths = []
    for i in range(u.shape[0]):
        path = os.path.join(outdir, f"m{i + 1:02d}{case}0.f{counter:05d}")
        write_fld(path, mesh=mesh, u=modes_u[i], p=modes_p[i], time=time)
        paths.append(path)
    return paths


def save_otd_restart(outdir: str, perts: PertState, base: FlowState,
                     counter: int = 1, case: str = "otd") -> str:
    """Write the full OTD basis (+ co-evolved base) as a restart checkpoint —
    the reference's `rst` basis outposting (neklab_analysis.f90:327-330)."""
    path = os.path.join(outdir, f"rst{case}0.f{counter:05d}.npz")
    data = {}
    for f in dataclasses.fields(perts):
        data["pert_" + f.name] = np.asarray(getattr(perts, f.name))
    for f in dataclasses.fields(base):
        data["base_" + f.name] = np.asarray(getattr(base, f.name))
    os.makedirs(outdir, exist_ok=True)
    # atomic write: a kill mid-write must not corrupt the only resume point
    # (same tmp+replace discipline as krylov/eigs._save_krylov_state).
    # NOTE: savez appends '.npz' unless the name already ends with it.
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **data)
    os.replace(tmp, path)
    return path


def _max_counter(outdir: str, prefix: str) -> int:
    """Largest .fNNNNN counter among files named <prefix>NNNNN* in outdir
    (0 if none) — used to continue output numbering across restarts."""
    best = 0
    try:
        names = os.listdir(outdir)
    except OSError:
        return 0
    for name in names:
        if name.startswith(prefix):
            digits = name[len(prefix):len(prefix) + 5]
            if digits.isdigit():
                best = max(best, int(digits))
    return best


def load_otd_restart(path: str, perts_tmpl: PertState, base_tmpl: FlowState):
    """Resume from a save_otd_restart checkpoint: (perts, base)."""
    with np.load(path) as z:
        pk = {f.name: jnp.asarray(z["pert_" + f.name], getattr(perts_tmpl, f.name).dtype)
              for f in dataclasses.fields(perts_tmpl)}
        bk = {f.name: jnp.asarray(z["base_" + f.name], getattr(base_tmpl, f.name).dtype)
              for f in dataclasses.fields(base_tmpl)}
    return dataclasses.replace(perts_tmpl, **pk), dataclasses.replace(base_tmpl, **bk)


def otd_analysis(
    mesh: SemMesh,
    cfg: LinConfig,
    opts: OtdOpts,
    base: FlowState,
    nsteps: int,
    init_perts: PertState | None = None,
    ub=None,
    tb=None,
    pc_e=None,
    outdir: str | None = None,
    seed: int = 7,
    ic_paths: list[str] | None = None,
    restart: str | None = None,
) -> OtdResult:
    """The reference's otd_analysis driver loop (neklab_analysis.f90:214-344):
    random (or file-loaded, or given) orthonormal ICs, chunked evolution,
    Ls/Lr spectra logging, projected-mode outposting every `iostep`, basis
    restart checkpoints every `iorststep`, OTD start deferred to `startstep`.
    ic_paths: OTDIC-style field files (see load_otd_ics). restart: resume
    from a save_otd_restart checkpoint (exact state, better than the
    reference's field-file roundtrip)."""
    fc = cfg.flow
    if init_perts is None and ic_paths:
        init_perts = load_otd_ics(mesh, cfg, ic_paths, r=opts.r, seed=seed)
    if init_perts is None:
        key = jax.random.PRNGKey(seed)
        u = jax.random.normal(key, (opts.r, mesh.ndim) + mesh.bm1.shape, mesh.bm1.dtype)
        u = jax.vmap(lambda f: mesh.vmask * sem.dsavg(mesh, f))(u)
        init_perts = jax.vmap(lambda ui: pert_initial(mesh, cfg, ui))(u)
        init_perts = orthonormalize_states(mesh, init_perts)
    perts = init_perts
    done = 0
    if restart is not None:
        perts, base = load_otd_restart(restart, perts, base)

    # pre-advance the base alone until the OTD start step (reference:
    # istep >= opts%startstep gate, neklab_analysis.f90:255-257)
    pre = min(max(opts.startstep - 1, 0), nsteps) if restart is None else 0
    if pre and opts.solve_baseflow:
        from .models.navier_stokes import advance

        base = advance(mesh, fc, base, pre, ub=ub, tb=tb, pc_e=pc_e)
    done += pre

    lr_history = []
    f_ls = f_lr = None
    io_counter = rst_counter = 0
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        mode = "a" if restart is not None else "w"
        f_ls = open(os.path.join(outdir, "Ls.dat"), mode)
        f_lr = open(os.path.join(outdir, "Lr.dat"), mode)
        if restart is not None:
            # continue past existing outputs so a resumed run never
            # overwrites the checkpoint it was resumed from
            io_counter = _max_counter(outdir, "m01otd0.f")
            rst_counter = _max_counter(outdir, "rstotd0.f")

    def next_event(k):
        """Steps until the next cadence boundary after k evolved OTD steps.
        Cadences of 0 mean 'never' (reference semantics); with no positive
        cadence at all, run the whole remainder in one chunk. orthostep is
        included so chunk boundaries land on GLOBAL orthostep multiples —
        otd_chunk counts ortho_every from the chunk start, so this keeps the
        realized re-orthonormalization schedule on the reference's global
        cadence rather than resetting phase at each print/io boundary."""
        cadences = [c for c in (opts.printstep, opts.iostep, opts.iorststep,
                                opts.orthostep) if c > 0]
        if not cadences:
            return nsteps - done
        return min(c - (k % c) for c in cadences)

    evolved = 0  # OTD steps evolved (after startstep)
    try:
        while done < nsteps:
            k = min(next_event(evolved), nsteps - done)
            base, perts, lr = otd_chunk(
                mesh, cfg, opts, base, perts, k, ramp=(evolved == 0 and restart is None),
                ub=ub, tb=tb, pc_e=pc_e, ortho_every=opts.orthostep,
            )
            done += k
            evolved += k
            lr_np = np.asarray(lr)
            # frozen-base runs never advance base.time; stamp the series with
            # the evolved-step clock so Ls/Lr.dat carry real time columns
            t = float(base.time) if opts.solve_baseflow else done * fc.dt
            if (opts.printstep > 0 and evolved % opts.printstep == 0) or done >= nsteps:
                lr_history.append((t, lr_np))
                ev = np.sort_complex(np.linalg.eigvals(lr_np))[::-1]
                evs = np.sort(np.linalg.eigvalsh(0.5 * (lr_np + lr_np.T)))[::-1]
                if f_ls is not None:
                    f_ls.write(" ".join(f"{v:.10e}" for v in evs) + f" {t:.6f}\n")
                    f_lr.write(
                        " ".join(f"{v.real:.10e} {v.imag:.10e}" for v in ev) + f" {t:.6f}\n"
                    )
                logger.info("otd t=%.4f: leading Re(eig Lr)=%.6f, sym=%.6f", t, ev[0].real, evs[0])
            if outdir and opts.iostep and evolved % opts.iostep == 0:
                io_counter += 1
                outpost_otd_modes(mesh, perts, lr_np, outdir, counter=io_counter, time=t)
            if outdir and opts.iorststep and evolved % opts.iorststep == 0:
                rst_counter += 1
                save_otd_restart(outdir, perts, base, counter=rst_counter)
    finally:
        if f_ls is not None:
            f_ls.close()
            f_lr.close()
    lr_np = lr_history[-1][1]
    return OtdResult(
        base=base,
        perts=perts,
        lr_history=lr_history,
        eigvals_lr=np.sort_complex(np.linalg.eigvals(lr_np))[::-1],
        eigvals_sym=np.sort(np.linalg.eigvalsh(0.5 * (lr_np + lr_np.T)))[::-1],
    )
