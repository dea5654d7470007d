"""Reference-scale BFS transient growth on the SHIPPED mesh and base flow.

Reference: /root/reference/examples/back_fstep/transient_growth/bfs.usr:8-18 —
tau = 18.0, nsv = 4, kdim = 512 on `bfs.re2` (2760 elements, lx1=6) starting
from `BF_bfs0.f00001`, Re = 600 (bfs.par viscosity -600), targetCFL 0.5,
pressure tol 1e-6 / velocity 1e-8 (f32 run uses 3e-6/3e-6 like the cylinder
parity run). The Lanczos SVD stops as soon as the nsv gains converge (the
reference's kdim=512 is a cap, not a cost), and checkpoints every few
iterations so a killed run resumes.

Outputs TRANSIENT_r04.json: leading optimal gains sigma_i = sqrt(max energy
amplification G(tau)), residuals, matvec count.

Usage: python examples/bfs_parity.py [--tau 18] [--kdim 512] [--out ...]
"""

import argparse
import json
import logging
import os
import sys
import time

logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

REF = "/root/reference/examples/back_fstep/transient_growth"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--platform", default=None)
    ap.add_argument("--tau", type=float, default=18.0)
    ap.add_argument("--kdim", type=int, default=512)
    ap.add_argument("--nsv", type=int, default=4)
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--cfl", type=float, default=0.5)
    ap.add_argument("--chunk", type=int, default=None,
                    help="steps per compiled chunk (default: auto — chunked "
                         "above 1024 steps, where the monolithic tau=18 "
                         "adjoint transpose crashed an earlier compiler)")
    ap.add_argument("--adj-tol-factor", type=float, default=1.0,
                    help="adjoint inner-solve tol scaling; 1.0 = exact "
                         "transpose of the forward program (best B-symmetry "
                         "of M*M for the Lanczos SVD, and ~2x cheaper "
                         "rmatvecs than the eigen-parity default 0.1)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--checkpoint", default=None)
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
    from neklab_tpu.mesh.bfs import REFERENCE_BFS_CACHE_TAG, reference_bfs_bc
    from neklab_tpu.mesh.re2 import mesh_from_re2
    from neklab_tpu.models.linearized import LinConfig
    from neklab_tpu.models.navier_stokes import FlowConfig
    from neklab_tpu.utils.fldfile import read_fld
    from neklab_tpu.vectors import flow_vector_space

    dtype = jnp.float64 if args.f64 else jnp.float32
    tols = dict(vtol=1e-8, ptol=1e-6) if args.f64 else dict(vtol=3e-6, ptol=3e-6)

    t0 = time.time()
    mesh = mesh_from_re2(f"{REF}/bfs.re2", order=5, dealias_order=8, dtype=dtype,
                         bc_fn=reference_bfs_bc, cache_tag=REFERENCE_BFS_CACHE_TAG)
    bf = read_fld(f"{REF}/BF_bfs0.f00001")
    base_u = jnp.asarray(bf.u, dtype)
    t_mesh = time.time() - t0
    print(f"mesh: {mesh.nel} elements, order 5; base flow t={bf.time}", flush=True)

    fc = FlowConfig(viscosity=1.0 / 600.0, dt=1e9, **tols)
    cfg = LinConfig(flow=fc)
    expA = ExponentialPropagator(mesh, cfg, base_u, tau=args.tau, cfl=args.cfl,
                                 chunk=args.chunk,
                                 adjoint_tol_factor=args.adj_tol_factor)
    print(f"propagator: dt={expA.dt:.6e}, nsteps={expA.nsteps}, "
          f"chunk={expA.chunk}", flush=True)

    space = flow_vector_space(mesh, 0)
    t1 = time.time()
    res = transient_growth_analysis_fixed_point(
        expA, space, kdim=args.kdim, nsv=args.nsv, tol=args.tol,
        checkpoint=args.checkpoint,
    )
    elapsed = time.time() - t1
    out = {
        "case": "BfsTransientGrowth (reference data: bfs.re2 + BF_bfs0.f00001)",
        "reference": "examples/back_fstep/transient_growth/bfs.usr:8-18 "
                     "(tau=18, nsv=4, kdim=512)",
        "mesh": {"file": "bfs.re2", "nel": mesh.nel, "order": 5, "dealias_order": 8},
        "baseflow": {"file": "BF_bfs0.f00001", "time": bf.time},
        "setup": {"tau": args.tau, "cfl": args.cfl, "dt": expA.dt,
                  "nsteps": expA.nsteps, "chunk": expA.chunk,
                  "adj_tol_factor": args.adj_tol_factor,
                  "kdim": args.kdim, "nsv": args.nsv,
                  "Re": 600.0, "tol": args.tol, **tols},
        "bc": "reference_bfs_bc (bfs.geo Physical Curves incl. upstream Sym "
              "floor; ADVICE r4 #1 fix)",
        "platform": jax.devices()[0].platform,
        "dtype": str(getattr(dtype, "__name__", dtype)),
        "sigma": [float(s) for s in res.sigma],
        "G_tau": [float(s) ** 2 for s in res.sigma],
        "residuals": [float(r) for r in res.residuals],
        "n_matvec": res.n_matvec,
        "svds_seconds": elapsed,
        "mesh_seconds": t_mesh,
    }
    print(json.dumps(out), flush=True)
    print(f"optimal gains G(tau={args.tau}): {out['G_tau']}  "
          f"({res.n_matvec} matvecs, {elapsed:.0f}s)", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
