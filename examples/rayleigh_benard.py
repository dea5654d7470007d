"""Rayleigh-Benard convection: critical Rayleigh number + supercritical growth.

Reference case: examples/rayBen/baseflow (Ra=1900 > Ra_c = 1707.762,
rayBen.par:6-10 — SURVEY section 6 last row). This driver both checks the
supercritical growth rate at a given Ra and brackets the critical value by
bisection on the leading eigenvalue of the Boussinesq-coupled propagator
about the conduction state.

Usage: python examples/rayleigh_benard.py [--ra 1900] [--critical]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

KC = 3.11632  # critical wavenumber (rigid-rigid)
RAC = 1707.762  # Chandrasekhar


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ra", type=float, default=1900.0)
    ap.add_argument("--critical", action="store_true", help="bracket Ra_c by bisection")
    ap.add_argument("--order", type=int, default=6)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--f64", action="store_true")
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

    from neklab_tpu.analysis import linear_stability_analysis_fixed_point
    from neklab_tpu.linops.exponential_propagator import ExponentialPropagator
    from neklab_tpu.mesh.box import box_mesh
    from neklab_tpu.models.linearized import LinConfig
    from neklab_tpu.models.navier_stokes import FlowConfig
    from neklab_tpu.vectors import flow_vector_space

    dtype = jnp.float64 if args.f64 else jnp.float32
    tols = (
        dict(vtol=1e-12, ptol=1e-12, ttol=1e-12)
        if args.f64
        else dict(vtol=1e-7, ptol=1e-7, ttol=1e-7)
    )

    def sigma(ra: float) -> float:
        lx = 2 * np.pi / KC
        mesh = box_mesh(
            (3, 3), ((0, lx), (0, 1.0)),
            {"x-": "P", "x+": "P", "y-": "W", "y+": "W"},
            order=args.order, bc_temp={"y-": "t", "y+": "t"}, dtype=dtype,
        )
        pr = 1.0
        fc = FlowConfig(viscosity=pr, dt=1e-3, nscal=1, conductivity=(1.0,), **tols)
        buoy = lambda m, u, th: jnp.concatenate(
            [jnp.zeros_like(th[0])[None], (ra * pr * th[0])[None]]
        )
        cfg = LinConfig(flow=fc, lin_forcing_fn=buoy)
        y = mesh.x[1]
        U = jnp.zeros((2,) + mesh.bm1.shape, dtype)
        Th = jnp.stack([1.0 - y])
        expA = ExponentialPropagator(mesh, cfg, U, Th, tau=0.05, dt=1e-3)
        space = flow_vector_space(mesh, 1)
        res = linear_stability_analysis_fixed_point(
            expA, space, kdim=30, nev=1, tol=1e-7, maxiter=10
        )
        return float(res.eigvals[0].real)

    t0 = time.time()
    out = {"case": "rayleigh_benard", "ra": args.ra, "ra_c_ref": RAC}
    s = sigma(args.ra)
    out["sigma"] = s
    out["supercritical"] = bool(s > 0)
    if args.critical:
        lo, hi = 1650.0, 1760.0
        s_lo, s_hi = sigma(lo), sigma(hi)
        ra_c = lo + (hi - lo) * (-s_lo) / (s_hi - s_lo)  # secant on sigma(Ra)
        out["ra_c"] = ra_c
        out["ra_c_err"] = abs(ra_c - RAC)
    out["seconds"] = time.time() - t0
    print(json.dumps(out), flush=True)
    msg = f"sigma(Ra={args.ra:.0f}) = {s:.5f} ({'UN' if s > 0 else ''}stable)"
    if "ra_c" in out:
        msg += f"; Ra_c = {out['ra_c']:.1f} (Chandrasekhar {RAC})"
    print(msg, flush=True)


if __name__ == "__main__":
    main()
