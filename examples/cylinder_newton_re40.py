"""Newton-Krylov cylinder base flow at Re=40 on the SHIPPED reference case.

Reference: /root/reference/examples/cylinder/newton/Re40_fixed_point/ —
`1cyl.re2` (1996 elements) + initial guess `BF.fld`, Newton tolerance 1e-6,
map horizon endTime = 1.0 with dt from targetCFL 0.5 (1cyl.par), dynamic
inner-tolerance scheduler. The committed artifacts there are the residual
plots (residual_quadratic.png): the oracle is the residual HISTORY —
superlinear (quadratic until inexact-solve floor) contraction to tol.

Outputs NEWTON_r04.json with the residual history and contraction factors.

Usage: python examples/cylinder_newton_re40.py [--out NEWTON_r04.json]
"""

import argparse
import json
import logging
import os
import sys
import time

logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

REF = "/root/reference/examples/cylinder/newton/Re40_fixed_point"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--platform", default=None)
    ap.add_argument("--tau", type=float, default=1.0, help="map horizon (endTime)")
    ap.add_argument("--tol", type=float, default=None,
                    help="Newton tolerance (reference 1e-6 in f64; f32 "
                         "default 3e-4: the response is evaluated through "
                         "f32 inner solves at vtol/ptol 3e-6, whose "
                         "accumulated noise floors |F| at ~1.3e-4 — "
                         "measured round 4 — so tighter f32 targets stall "
                         "at the floor, not at the root)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--vtol", type=float, default=None,
                    help="inner velocity tolerance override (tightening to "
                         "3e-7 lowers the f32 response floor ~10x and shows "
                         "two more decades of Newton contraction)")
    ap.add_argument("--ptol", type=float, default=None)
    ap.add_argument("--save-state", default=None,
                    help="save the converged base flow u as .npz")
    ap.add_argument("--init-state", default=None,
                    help="start Newton from a saved state instead of BF.fld "
                         "(the f32 -> f64 refinement path: the f64 "
                         "run then needs only 1-2 Newton steps)")
    ap.add_argument("--maxiter", type=int, default=20)
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

    from neklab_tpu.analysis import newton_fixed_point_iteration
    from neklab_tpu.mesh.re2 import mesh_from_re2
    from neklab_tpu.models.linearized import LinConfig
    from neklab_tpu.models.navier_stokes import FlowConfig
    from neklab_tpu.systems.fixed_point import FixedPointSystem
    from neklab_tpu.utils.fldfile import read_fld
    from neklab_tpu.vectors import flow_vector, flow_vector_space

    dtype = jnp.float64 if args.f64 else jnp.float32
    tols = dict(vtol=1e-9, ptol=1e-7) if args.f64 else dict(vtol=3e-6, ptol=3e-6)
    if args.vtol is not None:
        tols["vtol"] = args.vtol
    if args.ptol is not None:
        tols["ptol"] = args.ptol
    tol = args.tol if args.tol is not None else (1e-6 if args.f64 else 3e-4)

    t0 = time.time()
    mesh = mesh_from_re2(f"{REF}/1cyl.re2", order=5, dealias_order=8, dtype=dtype)
    bf = read_fld(f"{REF}/BF.fld")
    u0 = jnp.asarray(bf.u, dtype)
    if args.init_state:
        import numpy as _np

        with _np.load(args.init_state) as z:
            u0 = jnp.asarray(z["u"], dtype)
        print(f"init from {args.init_state}", flush=True)
    print(f"mesh: {mesh.nel} elements; initial guess BF.fld t={bf.time}", flush=True)

    fc = FlowConfig(viscosity=1.0 / 40.0, dt=1e9, **tols)
    cfg = LinConfig(flow=fc)
    # inflow/freestream BC values live in the mesh masks; the Dirichlet data
    # comes from the initial guess itself (it satisfies the BCs)
    ub = u0
    # recycle=8: Nek residual-projection deflation of the E solves — exact to
    # solver tolerance, large CG-iteration savings at f64 tolerances
    sysm = FixedPointSystem(mesh, cfg, tau=args.tau, ub=ub, cfl=0.5, recycle=8)
    space = flow_vector_space(mesh, 0)
    x0 = flow_vector(mesh, 0, u=u0)

    t1 = time.time()
    nres = newton_fixed_point_iteration(sysm, x0, space, tol=tol,
                                        maxiter=args.maxiter, gmres_kdim=40)
    elapsed = time.time() - t1
    hist = [float(h) for h in nres.history]
    # contraction factors r_{k+1}/r_k (superlinear: decreasing ratios until
    # the inexact-solve floor)
    ratios = [hist[i + 1] / hist[i] for i in range(len(hist) - 1)]
    out = {
        "case": "CylNewtonRe40 (reference data: Re40_fixed_point/1cyl.re2 + BF.fld)",
        "reference": "examples/cylinder/newton/Re40_fixed_point (tol 1e-6, "
                     "endTime 1.0, targetCFL 0.5; residual_quadratic.png)",
        "mesh": {"file": "1cyl.re2", "nel": mesh.nel, "order": 5},
        "setup": {"tau": args.tau, "Re": 40.0, "tol": tol, **tols},
        "platform": jax.devices()[0].platform,
        "dtype": str(getattr(dtype, "__name__", dtype)),
        "newton_converged": bool(nres.converged),
        "newton_residual": float(nres.residual_norm),
        "iterations": int(nres.iterations),
        "residual_history": hist,
        "contraction_ratios": ratios,
        "superlinear": bool(len(ratios) >= 2 and ratios[1] < ratios[0]),
        "f32_floor_note": "f32 inner solves (vtol/ptol 3e-6) floor the "
                          "response norm near ~1.3e-4; the reference's 1e-6 "
                          "target is an f64 number (run --f64 --platform "
                          "cpu for the tight-tolerance variant)",
        "elapsed": elapsed,
        "mesh_seconds": t1 - t0,
    }
    print(json.dumps(out), flush=True)
    print(f"newton Re40: converged={out['newton_converged']} "
          f"|F|={out['newton_residual']:.3e} history={hist}", flush=True)
    if args.save_state:
        np.savez(args.save_state, u=np.asarray(nres.x["u"]))
        print(f"saved state to {args.save_state}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
