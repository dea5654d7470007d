"""Reference-data parity run: the published oracle on the reference's own data.

Reproduces the reference's single shipped integration test (CylEigsDir,
/root/reference/test/neklabTests.py:16-47): direct linear stability of the
cylinder wake at Re=50 on the SHIPPED 1996-element mesh `1cyl.re2` (lx1=6,
i.e. order 5; lxd=9 dealiasing) starting from the SHIPPED base flow
`BF_1cyl0.f00001`, with the exponential propagator at tau=1.0 (CFL 0.5
re-derivation, exponential_propagator.f90:12) and an Arnoldi/Krylov-Schur
eigensolve at kdim=128, nev=2 (1cyl.usr:11).

Oracle: leading Floquet multiplier modulus |mu1| = 1.0156 +- 1e-4
(test/neklabTests.py:43-45).

Usage:
    python examples/cylinder_parity.py [--f64] [--platform cpu] \
        [--kdim 128] [--out PARITY_r02.json]
"""

import argparse
import json
import logging
import os
import sys
import time

logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

REF = "/root/reference/examples/cylinder/stability/direct"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--platform", default=None)
    ap.add_argument("--kdim", type=int, default=128)
    ap.add_argument("--nev", type=int, default=2)
    ap.add_argument("--tau", type=float, default=1.0)
    ap.add_argument("--maxiter", type=int, default=8)
    ap.add_argument("--out", default=None)
    ap.add_argument("--save-evec", default=None, help="npz path for the leading eigenvector")
    ap.add_argument("--checkpoint", default=None,
                    help="Arnoldi kill-and-resume state file (krylov.eigs)")
    ap.add_argument("--tol", type=float, default=1e-6,
                    help="Ritz-residual tolerance; eigenvalue error scales "
                         "as kappa(mu) * tol (~40x here), so the 1e-4 oracle "
                         "band needs ~1e-6")
    ap.add_argument("--check-every", type=int, default=8)
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
    from neklab_tpu.mesh.re2 import mesh_from_re2
    from neklab_tpu.models.linearized import LinConfig
    from neklab_tpu.models.navier_stokes import FlowConfig
    from neklab_tpu.utils.fldfile import read_fld
    from neklab_tpu.vectors import flow_vector_space

    dtype = jnp.float64 if args.f64 else jnp.float32
    # reference tolerances: 1cyl.par PRESSURE residualTol 1e-7, VELOCITY 1e-9
    tols = dict(vtol=1e-9, ptol=1e-7) if args.f64 else dict(vtol=3e-6, ptol=3e-6)

    t0 = time.time()
    # lx1=6 -> order 5; lxd=9 -> dealias order 8 (reference SIZE:9-10)
    mesh = mesh_from_re2(f"{REF}/1cyl.re2", order=5, dealias_order=8, dtype=dtype)
    bf = read_fld(f"{REF}/BF_1cyl0.f00001")
    assert np.abs(bf.x - np.asarray(mesh.x, np.float64)).max() < 1e-4
    base_u = jnp.asarray(bf.u, dtype)
    t_mesh = time.time() - t0
    print(f"mesh: {mesh.nel} elements, order 5; base flow t={bf.time}", flush=True)

    fc = FlowConfig(viscosity=1.0 / 50.0, dt=1e9, **tols)  # dt re-derived below
    cfg = LinConfig(flow=fc)
    expA = ExponentialPropagator(mesh, cfg, base_u, tau=args.tau, cfl=0.5)
    print(f"propagator: dt={expA.dt:.6e}, nsteps={expA.nsteps}", flush=True)

    space = flow_vector_space(mesh, 0)
    eig_tol = args.tol
    t1 = time.time()
    res = linear_stability_analysis_fixed_point(
        expA, space, kdim=args.kdim, nev=args.nev, tol=eig_tol,
        maxiter=args.maxiter, checkpoint=args.checkpoint,
        check_every=args.check_every,
    )
    elapsed = time.time() - t1

    mu1 = res.multipliers[0]
    out = {
        "case": "CylEigsDir (reference data: 1cyl.re2 + BF_1cyl0.f00001)",
        "oracle": {"mu1_abs": 1.0156, "delta": 1e-4,
                   "source": "reference test/neklabTests.py:43-45"},
        "mesh": {"file": "1cyl.re2", "nel": mesh.nel, "order": 5, "dealias_order": 8},
        "baseflow": {"file": "BF_1cyl0.f00001", "time": bf.time},
        "setup": {"tau": args.tau, "cfl": 0.5, "dt": expA.dt, "nsteps": expA.nsteps,
                  "kdim": args.kdim, "nev": args.nev, "Re": 50.0,
                  "eig_tol": eig_tol, **tols},
        "platform": jax.devices()[0].platform,
        "dtype": str(dtype.__name__ if hasattr(dtype, "__name__") else dtype),
        "mu1_abs": float(np.abs(mu1)),
        "mu1": [float(mu1.real), float(mu1.imag)],
        "in_band": bool(abs(float(np.abs(mu1)) - 1.0156) < 1e-4),
        "eigvals_lambda": [[float(v.real), float(v.imag)] for v in res.eigvals],
        "sigma": float(res.eigvals[0].real),
        "omega": float(abs(res.eigvals[0].imag)),
        "residuals": [float(r) for r in res.residuals],
        "n_matvec": res.n_matvec,
        "eigs_seconds": elapsed,
        "mesh_seconds": t_mesh,
    }
    print(json.dumps(out), flush=True)
    print(
        f"|mu1| = {out['mu1_abs']:.6f}  (oracle 1.0156 +- 1e-4; "
        f"in_band={out['in_band']}; {res.n_matvec} matvecs, {elapsed:.0f}s)",
        flush=True,
    )
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    if args.save_evec:
        v1 = res.eigenvectors[0]["u"]
        np.savez_compressed(
            args.save_evec,
            u_re=np.asarray(v1.real, np.float64),
            u_im=np.asarray(v1.imag, np.float64),
            mu1=np.asarray([mu1.real, mu1.imag]),
        )


if __name__ == "__main__":
    main()
