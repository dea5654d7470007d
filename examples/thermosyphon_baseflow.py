"""Thermosyphon (annular natural-convection loop): base flow + stability.

Reference case: examples/thermosyphon/baseflow (annulus, Boussinesq
f_y = Pr Ra theta, wall temperature 0.5(1 + tanh(-20 y)) — hot bottom /
cold top; Pr = 0.2, tsyphon.usr userbc/userf). Pipeline: time integration to
start the convective circulation, Newton-Krylov to the steady convecting
state, then the leading stability eigenvalues about it.

Usage: python examples/thermosyphon_baseflow.py [--ra 510] [--preset coarse|medium]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

PR = 0.2


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ra", type=float, default=510.0)
    ap.add_argument("--preset", default="coarse", choices=["coarse", "medium"])
    ap.add_argument("--platform", default=None)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--outdir", default=None)
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.f64:
        jax.config.update("jax_enable_x64", True)
    from neklab_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import numpy as np
    import jax.numpy as jnp

    from neklab_tpu.analysis import (
        linear_stability_analysis_fixed_point,
        newton_fixed_point_iteration,
    )
    from neklab_tpu.linops.exponential_propagator import ExponentialPropagator
    from neklab_tpu.mesh.cylinder import annulus_mesh
    from neklab_tpu.models.linearized import LinConfig
    from neklab_tpu.models.navier_stokes import FlowConfig, advance, initial_state
    from neklab_tpu.models.precond import build_e_preconditioner
    from neklab_tpu.systems.fixed_point import FixedPointSystem
    from neklab_tpu.vectors import flow_vector, flow_vector_space

    presets = {
        #         nel_r nel_t order dt    spin kdim
        "coarse": (3, 12, 4, 5e-3, 400, 24),
        "medium": (4, 20, 6, 2.5e-3, 1200, 40),
    }
    nel_r, nel_t, order, dt, nspin, kdim = presets[args.preset]
    ra = args.ra
    dtype = jnp.float64 if args.f64 else jnp.float32
    tols = (
        dict(vtol=1e-11, ptol=1e-10, ttol=1e-11)
        if args.f64
        else dict(vtol=1e-7, ptol=1e-7, ttol=1e-7)
    )

    mesh = annulus_mesh(nel_r, nel_t, r_in=0.6, r_out=1.0, order=order,
                        grading=1.0, outer_bc="W", bc_temp=("t", "t"), dtype=dtype)
    buoy = lambda m, u, th: jnp.stack([jnp.zeros_like(th[0]), PR * ra * th[0]])
    fc = FlowConfig(
        viscosity=PR, dt=dt, nscal=1, conductivity=(1.0,),
        forcing_fn=lambda m, t, u, th: buoy(m, u, th), **tols,
    )
    cfg = LinConfig(flow=fc, lin_forcing_fn=buoy)
    tb = jnp.stack([0.5 * (1.0 + jnp.tanh(-20.0 * mesh.x[1]))])
    pc = build_e_preconditioner(mesh, dt / (11 / 6))

    st = initial_state(mesh, fc, theta=tb * mesh.tmask + (1 - mesh.tmask) * tb)
    t0 = time.time()
    st = advance(mesh, fc, st, nspin, tb=tb, pc_e=pc)
    print(f"spin-up to t={float(st.time):.2f} in {time.time()-t0:.0f}s; "
          f"max|u| = {float(jnp.max(jnp.abs(st.u))):.4f}", flush=True)

    sysm = FixedPointSystem(mesh, cfg, tau=0.3, tb=tb, dt=dt)
    space = flow_vector_space(mesh, 1)
    x0 = flow_vector(mesh, 1, u=st.u, theta=st.theta)
    newton_tol = 1e-8 if args.f64 else 1e-4
    nres = newton_fixed_point_iteration(sysm, x0, space, tol=newton_tol,
                                        maxiter=12, gmres_kdim=25)
    print(f"newton: converged={nres.converged} |F|={nres.residual_norm:.3e}", flush=True)

    expA = ExponentialPropagator(mesh, cfg, nres.x["u"], nres.x["theta"], tau=0.3, dt=dt)
    eres = linear_stability_analysis_fixed_point(
        expA, space, kdim=kdim, nev=2, tol=1e-6, maxiter=10, outdir=args.outdir
    )
    out = {
        "case": "thermosyphon_baseflow",
        "ra": ra,
        "pr": PR,
        "preset": args.preset,
        "newton_converged": bool(nres.converged),
        "newton_residual": float(nres.residual_norm),
        "max_u": float(jnp.max(jnp.abs(nres.x["u"]))),
        "eigvals": [[v.real, v.imag] for v in eres.eigvals],
        "sigma1": float(eres.eigvals[0].real),
        "n_matvec": eres.n_matvec,
    }
    print(json.dumps(out), flush=True)
    print(f"leading eigenvalue sigma1 = {out['sigma1']:.5f} "
          f"({'UN' if out['sigma1'] > 0 else ''}stable convecting state)", flush=True)


if __name__ == "__main__":
    main()
