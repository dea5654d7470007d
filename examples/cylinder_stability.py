"""Cylinder-wake linear stability (the reference's headline case).

Pipeline (SURVEY 3.1 + examples/cylinder/stability/direct):
  1. DNS spin-up from a smooth symmetric start (stays on the symmetric
     manifold, near the unstable steady state);
  2. Newton-Krylov base-flow computation (fixed point of Phi_tau);
  3. Arnoldi/Krylov-Schur eigensolve of exp(tau A), tau = 1.0, about it.

Oracle: leading Floquet-multiplier modulus |mu_1| = 1.0156 +- 1e-4 at Re=50
(reference test/neklabTests.py:43-45; equivalently growth rate
sigma = log|mu_1| = 0.01548 with shedding frequency omega ~ 0.75).

Usage: python examples/cylinder_stability.py [--preset coarse|medium|fine]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


PRESETS = {
    #          nel_r nel_t  rout order dt     spin  kdim nev
    "coarse": (6, 14, 12.0, 4, 1.0e-2, 3000, 40, 2),
    "medium": (8, 20, 20.0, 6, 5.0e-3, 8000, 64, 4),
    "fine": (10, 28, 30.0, 7, 3.0e-3, 15000, 96, 4),
}


def make_mesh(nel_r, nel_t, r_out, order, dtype):
    """Annulus around the unit-diameter cylinder, velocity inflow and outflow
    on the outer circle."""
    from neklab_tpu.mesh.cylinder import annulus_mesh

    return annulus_mesh(
        nel_r, nel_t, r_in=0.5, r_out=r_out, order=order, grading=1.5,
        outer_bc="vO", shift=0.25, dtype=dtype,
    )


def run(preset="medium", f64=False):
    """Spin-up, Newton base flow and eigensolve; returns the result record.
    preset: a PRESETS name or a tuple of the same fields."""
    import numpy as np
    import jax.numpy as jnp

    from neklab_tpu.analysis import (
        linear_stability_analysis_fixed_point,
        newton_fixed_point_iteration,
    )
    from neklab_tpu.linops.exponential_propagator import ExponentialPropagator
    from neklab_tpu.models.linearized import LinConfig
    from neklab_tpu.models.navier_stokes import FlowConfig, advance, initial_state
    from neklab_tpu.models.precond import build_e_preconditioner
    from neklab_tpu.systems.fixed_point import FixedPointSystem
    from neklab_tpu.vectors import flow_vector, flow_vector_space

    nel_r, nel_t, r_out, order, dt, nspin, kdim, nev = (
        PRESETS[preset] if isinstance(preset, str) else preset)

    dtype = jnp.float64 if f64 else jnp.float32
    tols = dict(vtol=1e-10, ptol=1e-9) if f64 else dict(vtol=3e-6, ptol=3e-6)

    Re = 50.0
    mesh = make_mesh(nel_r, nel_t, r_out, order, dtype)
    print(f"mesh: {mesh.nel} elements, order {order}, r_out {r_out}", flush=True)
    fc = FlowConfig(viscosity=1 / Re, dt=dt, **tols)
    cfg = LinConfig(flow=fc)
    pc = build_e_preconditioner(mesh, dt / (11 / 6))

    r = jnp.sqrt(mesh.x[0] ** 2 + mesh.x[1] ** 2)
    free = (r > 0.5 + 1e-8).astype(dtype)
    ub = jnp.stack([free, jnp.zeros_like(free)])
    ramp = 1 - jnp.exp(-3.0 * (r - 0.5))
    st = initial_state(mesh, fc, u=mesh.vmask * jnp.stack([ramp, 0 * ramp]) + (1 - mesh.vmask) * ub)

    t0 = time.time()
    st = advance(mesh, fc, st, nspin, ub=ub, pc_e=pc)
    spin_seconds = time.time() - t0
    print(f"spin-up to t={float(st.time):.1f} in {spin_seconds:.0f}s", flush=True)

    t0 = time.time()
    system = FixedPointSystem(mesh, cfg, tau=0.5, ub=ub, dt=dt)
    space = flow_vector_space(mesh, 0)
    newton_tol = 1e-8 if f64 else 2e-4
    nres = newton_fixed_point_iteration(
        system, flow_vector(mesh, 0, u=st.u), space, tol=newton_tol, maxiter=15, gmres_kdim=30
    )
    newton_seconds = time.time() - t0
    print(f"newton: converged={nres.converged} |F|={nres.residual_norm:.3e}", flush=True)

    expA = ExponentialPropagator(mesh, cfg, nres.x["u"], tau=1.0, dt=dt)
    eig_tol = 1e-7 if f64 else 1e-5
    t0 = time.time()
    eres = linear_stability_analysis_fixed_point(
        expA, space, kdim=kdim, nev=nev, tol=eig_tol, maxiter=12
    )
    return {
        "preset": preset,
        "nel": mesh.nel,
        "order": order,
        "eigvals": [[v.real, v.imag] for v in eres.eigvals],
        "mu1_abs": float(np.abs(eres.multipliers[0])),
        "sigma": float(eres.eigvals[0].real),
        "omega": float(abs(eres.eigvals[0].imag)),
        "n_matvec": eres.n_matvec,
        "newton_converged": bool(nres.converged),
        "newton_residual": float(nres.residual_norm),
        "spin_seconds": spin_seconds,
        "newton_seconds": newton_seconds,
        "eigs_seconds": time.time() - t0,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="medium", choices=sorted(PRESETS))
    ap.add_argument("--platform", default=None, help="cpu to force CPU")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.f64:
        jax.config.update("jax_enable_x64", True)
    from neklab_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    out = run(args.preset, f64=args.f64)
    print(json.dumps(out), flush=True)
    print(f"|mu1| = {out['mu1_abs']:.6f}  (oracle 1.0156 +- 1e-4)", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)


if __name__ == "__main__":
    main()
