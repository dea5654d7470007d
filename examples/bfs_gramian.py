"""BFS resolvent frequency sweep at the REFERENCE conditions (gramian case).

Reference: /root/reference/examples/back_fstep/gramian/bfs.usr — on `bfs.re2`
+ `BF_bfs0.f00001` (Re=600), force with the actuator Gaussian

    f_y(x, y) = exp(-((x-0.6)^2 + (y-1.0)^2) / 0.6^2)          (:58-71)

and sweep omega = 0.2 i, i = 1..15 (:30-31), recording the squared response
amplitude 0.5*||R(i omega) f||_B^2 per frequency into `amplitude.dat`
(:42-45). The periodic-response GMRES (kdim=64, rtol 1e-6 in the reference's
resolvent.f90:122-130; f32 run relaxes rtol) is warm-started from the
previous frequency's solution, and every completed frequency is appended to
the output files immediately, so a partial sweep still yields an artifact.

Usage: python examples/bfs_gramian.py [--omegas 0.2 ... ] [--outdir DIR]
"""

import argparse
import json
import logging
import os
import sys
import time

logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

REF = "/root/reference/examples/back_fstep/gramian"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--platform", default=None)
    ap.add_argument("--omegas", type=float, nargs="*", default=None,
                    help="default: 0.2*i for i=1..15 (reference bfs.usr:30-31)")
    ap.add_argument("--rtol", type=float, default=1e-5)
    ap.add_argument("--kdim", type=int, default=64)
    ap.add_argument("--outdir", default="artifacts/bfs_gramian")
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

    from neklab_tpu.linops.resolvent import Resolvent
    from neklab_tpu.mesh.bfs import REFERENCE_BFS_CACHE_TAG, reference_bfs_bc
    from neklab_tpu.mesh.re2 import mesh_from_re2
    from neklab_tpu.models.linearized import LinConfig
    from neklab_tpu.models.navier_stokes import FlowConfig
    from neklab_tpu.utils.fldfile import read_fld

    dtype = jnp.float64 if args.f64 else jnp.float32
    tols = dict(vtol=1e-8, ptol=1e-6) if args.f64 else dict(vtol=3e-6, ptol=3e-6)
    omegas = args.omegas or [0.2 * i for i in range(1, 16)]

    mesh = mesh_from_re2(f"{REF}/bfs.re2", order=5, dealias_order=8, dtype=dtype,
                         bc_fn=reference_bfs_bc, cache_tag=REFERENCE_BFS_CACHE_TAG)
    bf = read_fld(f"{REF}/BF_bfs0.f00001")
    base_u = jnp.asarray(bf.u, dtype)
    print(f"mesh: {mesh.nel} elements; base flow t={bf.time}", flush=True)

    fc = FlowConfig(viscosity=1.0 / 600.0, dt=1e9, **tols)
    cfg = LinConfig(flow=fc)
    # one preconditioner for the whole sweep (dt-invariant; resolvent.py)
    from neklab_tpu.models.precond import build_e_preconditioner

    pc_shared = build_e_preconditioner(mesh, 1.0)

    # actuator Gaussian (reference make_actuator, bfs.usr:58-71)
    x, y = mesh.x[0], mesh.x[1]
    g = jnp.exp(-(((x - 0.6) ** 2) + (y - 1.0) ** 2) / 0.6 ** 2)
    zero = jnp.zeros_like(g)
    th0 = jnp.zeros((0,) + mesh.bm1.shape, dtype)
    f_re = {"u": jnp.stack([zero, g]), "theta": th0}
    f_im = {"u": jnp.stack([zero, zero]), "theta": th0}
    forcing = {"re": f_re, "im": f_im}

    os.makedirs(args.outdir, exist_ok=True)
    amp_path = os.path.join(args.outdir, "amplitude.dat")
    json_path = os.path.join(args.outdir, "BFS_GRAMIAN_r05.json")
    bm1 = mesh.bm1

    def bnorm2(resp):
        tot = 0.0
        for part in ("re", "im"):
            tot += float(jnp.sum(resp[part]["u"] ** 2 * bm1))
        return tot

    # resume: frequencies already in amplitude.dat are skipped (a retried
    # run keeps its completed sweep points)
    done_omegas = set()
    rows = []
    if os.path.exists(amp_path):
        with open(amp_path) as f:
            for line in f:
                parts = line.split()
                if len(parts) == 2:
                    done_omegas.add(round(float(parts[0]), 6))
                    rows.append({"omega": float(parts[0]),
                                 "half_sq_norm": float(parts[1]),
                                 "resumed": True})
        if done_omegas:
            print(f"resuming: {sorted(done_omegas)} already done", flush=True)
    omegas = [om for om in omegas if round(om, 6) not in done_omegas]
    x_warm = None
    t_all = time.time()
    with open(amp_path, "a") as famp:
        for om in omegas:
            t0 = time.time()
            R = Resolvent(mesh, cfg, base_u, omega=om, cfl=0.5,
                          gmres_kdim=args.kdim, gmres_rtol=args.rtol,
                          pc_e=pc_shared)
            resp = R.matvec(forcing, x0=x_warm)
            x_warm = resp["re"]  # warm start for the next frequency
            a2 = 0.5 * bnorm2(resp)
            row = {"omega": om, "half_sq_norm": a2,
                   "dt": R.dt, "nsteps": R.nsteps,
                   "gmres_matvecs": getattr(R, "last_gmres_matvecs", None),
                   "seconds": time.time() - t0}
            rows.append(row)
            famp.write(f"{om:.6f} {a2:.10e}\n")
            famp.flush()
            with open(json_path, "w") as f:
                json.dump({
                    "case": "BfsGramian (reference data: bfs.re2 + BF_bfs0.f00001)",
                    "reference": "examples/back_fstep/gramian/bfs.usr:30-48 "
                                 "(omega=0.2i, i=1..15; amplitude.dat)",
                    "actuator": "vy Gaussian at (0.6, 1.0), width 0.6",
                    "bc": "reference_bfs_bc (bfs.geo Physical Curves incl. "
                          "upstream Sym floor; ADVICE r4 #1 fix)",
                    "Re": 600.0, "rtol": args.rtol, "kdim": args.kdim,
                    "dtype": str(getattr(dtype, "__name__", dtype)),
                    "sweep": rows,
                    "elapsed": time.time() - t_all,
                }, f, indent=1)
            print(f"omega={om:.2f}: 0.5||x||^2 = {a2:.6e} "
                  f"({row['gmres_matvecs']} matvecs, {row['seconds']:.0f}s)",
                  flush=True)
    print(json.dumps({"sweep_points": len(rows), "amplitude": amp_path}), flush=True)


if __name__ == "__main__":
    main()
