"""Backward-facing-step transient growth (SVD of the propagator).

Reference case: examples/back_fstep/transient_growth (tau=18, nsv=4,
kdim=512 — SURVEY 3.3): Lanczos SVD of exp(tau A) about the steady BFS flow;
the singular values are the optimal energy gains, outposted with the optimal
perturbations ('prt') and responses ('rsp').

Usage: python examples/bfs_transient_growth.py [--preset coarse|medium|fine]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="medium", choices=["coarse", "medium", "fine"])
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

    from neklab_tpu.analysis import transient_growth_analysis_fixed_point
    from neklab_tpu.linops.exponential_propagator import ExponentialPropagator
    from neklab_tpu.mesh.bfs import bfs_inflow, bfs_mesh
    from neklab_tpu.models.linearized import LinConfig
    from neklab_tpu.models.navier_stokes import FlowConfig, advance, initial_state
    from neklab_tpu.models.precond import build_e_preconditioner
    from neklab_tpu.vectors import flow_vector_space

    presets = {
        #         li lo  n_li n_lo n_yin n_ys order dt    spin  tau  nsv kdim re
        "coarse": (2, 10, 2, 8, 2, 2, 5, 2e-2, 800, 4.0, 2, 16, 300.0),
        "medium": (3, 16, 3, 14, 2, 2, 6, 1e-2, 2500, 9.0, 4, 32, 500.0),
        "fine": (4, 24, 4, 20, 3, 3, 7, 5e-3, 6000, 18.0, 4, 64, 500.0),
    }
    li, lo, nli, nlo, nyin, nys, order, dt, nspin, tau, nsv, kdim, re = presets[args.preset]
    dtype = jnp.float64 if args.f64 else jnp.float32
    tols = dict(vtol=1e-11, ptol=1e-10) if args.f64 else dict(vtol=1e-6, ptol=1e-6)

    mesh = bfs_mesh(li=li, lo=lo, nel_li=nli, nel_lo=nlo, nel_y_in=nyin,
                    nel_y_step=nys, order=order, dtype=dtype)
    fc = FlowConfig(viscosity=1 / re, dt=dt, **tols)
    cfg = LinConfig(flow=fc)
    pc = build_e_preconditioner(mesh, dt / (11 / 6))
    ub = bfs_inflow(mesh)
    st = initial_state(mesh, fc, u=mesh.vmask * ub + (1 - mesh.vmask) * ub)
    t0 = time.time()
    st = advance(mesh, fc, st, nspin, ub=ub, pc_e=pc)
    print(f"base flow to t={float(st.time):.1f} in {time.time()-t0:.0f}s", flush=True)

    expA = ExponentialPropagator(mesh, cfg, st.u, tau=tau, dt=dt)
    space = flow_vector_space(mesh, 0)
    t0 = time.time()
    res = transient_growth_analysis_fixed_point(
        expA, space, kdim=kdim, nsv=nsv, tol=1e-6, outdir=args.outdir
    )
    out = {
        "case": "bfs_transient_growth",
        "preset": args.preset,
        "re": re,
        "tau": tau,
        "sigma": [float(s) for s in res.sigma],
        "gain": [float(s) ** 2 for s in res.sigma],
        "n_matvec": res.n_matvec,
        "seconds": time.time() - t0,
    }
    print(json.dumps(out), flush=True)
    print(f"optimal gains G(tau={tau}) = {[f'{g:.1f}' for g in out['gain']]}", flush=True)


if __name__ == "__main__":
    main()
