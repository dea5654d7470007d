"""Reference-data ADJOINT parity run: adjoint eigensolve on the shipped mesh.

The reference ships a cylinder adjoint stability case with the SAME oracle
spectrum (/root/reference/examples/cylinder/stability/adjoint/1cyl.usr:21:
`linear_stability_analysis_fixed_point(exptA, kdim=128, nev=2,
adjoint=.true.)` on `1cyl.re2` + `BF_1cyl0.f00001`): the adjoint operator's
eigenvalues are the complex conjugates of the direct ones, so the leading
Floquet multiplier modulus oracle |mu1| = 1.0156 +- 1e-4 applies unchanged.

This run additionally verifies BIORTHOGONALITY against the direct mode
(pass --direct-evec saved by `cylinder_parity.py --save-evec`): for
M u = mu u and M* w = nu w, <w, u>_B = 0 unless nu = conj(mu), so the 2x2
cross-Gram over the leading conjugate pairs must be (after conjugate
matching) diagonal-dominant.

Usage:
    python examples/cylinder_parity.py --save-evec dir_evec.npz
    python examples/cylinder_parity_adjoint.py --direct-evec dir_evec.npz \
        --out PARITY_r04_adj.json
"""

import argparse
import json
import logging
import os
import sys
import time

logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

REF = "/root/reference/examples/cylinder/stability/adjoint"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--platform", default=None)
    ap.add_argument("--kdim", type=int, default=128)
    ap.add_argument("--nev", type=int, default=2)
    ap.add_argument("--tau", type=float, default=1.0)
    ap.add_argument("--maxiter", type=int, default=8)
    ap.add_argument("--out", default=None)
    ap.add_argument("--direct-evec", default=None,
                    help="npz from cylinder_parity.py --save-evec (enables "
                         "the biorthogonality check)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--vtol", type=float, default=None,
                    help="inner velocity-solve tolerance override (default "
                         "3e-6 f32 / 1e-9 f64). NOTE: the round-3 out-of-band "
                         "results were NOT an inner-tolerance problem — the "
                         "Ritz residual (see --tol) was left at ~1e-5 on an "
                         "operator with eigenvalue condition ~40 (±4e-4 "
                         "eigenvalue uncertainty, 4x the oracle band)")
    ap.add_argument("--ptol", type=float, default=None)
    ap.add_argument("--tol", type=float, default=1e-6,
                    help="Ritz-residual tolerance of the eigensolve. The "
                         "oracle band is 1e-4 on |mu1| and kappa(mu1) ~ 40, "
                         "so the residual must reach ~1e-6 (NOT the old 1e-5 "
                         "early-exit default) for the eigenvalue to be "
                         "trustworthy at the band width")
    ap.add_argument("--check-every", type=int, default=8,
                    help="early-exit convergence check cadence (0 = only at "
                         "kdim)")
    ap.add_argument("--save-evec", default=None,
                    help="npz path for the leading ADJOINT eigenvector")
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
    tols = dict(vtol=1e-9, ptol=1e-7) if args.f64 else dict(vtol=3e-6, ptol=3e-6)
    if args.vtol is not None:
        tols["vtol"] = args.vtol
    if args.ptol is not None:
        tols["ptol"] = args.ptol

    t0 = time.time()
    mesh = mesh_from_re2(f"{REF}/1cyl.re2", order=5, dealias_order=8, dtype=dtype)
    bf = read_fld(f"{REF}/BF_1cyl0.f00001")
    base_u = jnp.asarray(bf.u, dtype)
    t_mesh = time.time() - t0
    print(f"mesh: {mesh.nel} elements, order 5; base flow t={bf.time}", flush=True)

    fc = FlowConfig(viscosity=1.0 / 50.0, dt=1e9, **tols)
    cfg = LinConfig(flow=fc)
    expA = ExponentialPropagator(mesh, cfg, base_u, tau=args.tau, cfl=0.5)
    print(f"propagator: dt={expA.dt:.6e}, nsteps={expA.nsteps}", flush=True)

    space = flow_vector_space(mesh, 0)
    eig_tol = args.tol
    t1 = time.time()
    res = linear_stability_analysis_fixed_point(
        expA, space, kdim=args.kdim, nev=args.nev, tol=eig_tol,
        maxiter=args.maxiter, adjoint=True, checkpoint=args.checkpoint,
        check_every=args.check_every,
    )
    elapsed = time.time() - t1

    mu1 = res.multipliers[0]
    out = {
        "case": "CylEigsAdj (reference data: adjoint/1cyl.re2 + BF_1cyl0.f00001)",
        "oracle": {"mu1_abs": 1.0156, "delta": 1e-4,
                   "source": "adjoint spectrum = conj(direct); "
                             "reference test/neklabTests.py:43-45 + "
                             "examples/cylinder/stability/adjoint/1cyl.usr:21"},
        "mesh": {"file": "1cyl.re2", "nel": mesh.nel, "order": 5, "dealias_order": 8},
        "baseflow": {"file": "BF_1cyl0.f00001", "time": bf.time},
        "setup": {"tau": args.tau, "cfl": 0.5, "dt": expA.dt, "nsteps": expA.nsteps,
                  "kdim": args.kdim, "nev": args.nev, "Re": 50.0,
                  "adjoint": True, "eig_tol": eig_tol, **tols},
        "platform": jax.devices()[0].platform,
        "dtype": str(getattr(dtype, "__name__", dtype)),
        "mu1_abs": float(np.abs(mu1)),
        "mu1": [float(mu1.real), float(mu1.imag)],
        "in_band": bool(abs(float(np.abs(mu1)) - 1.0156) < 1e-4),
        "eigvals_lambda_adj": [[float(v.real), float(v.imag)] for v in res.eigvals],
        "residuals": [float(r) for r in res.residuals],
        "n_matvec": res.n_matvec,
        "eigs_seconds": elapsed,
        "mesh_seconds": t_mesh,
    }

    if args.direct_evec and not os.path.exists(args.direct_evec):
        print(f"direct-evec file {args.direct_evec} missing: skipping "
              "biorthogonality check", flush=True)
        args.direct_evec = None
    if args.direct_evec:
        with np.load(args.direct_evec) as z:
            u1 = z["u_re"] + 1j * z["u_im"]  # [ndim, ...]
            mu_dir = complex(z["mu1"][0], z["mu1"][1])
        w1c = res.eigenvectors[0]["u"]
        w1 = np.asarray(w1c.real, np.float64) + 1j * np.asarray(w1c.imag, np.float64)
        bm1 = np.asarray(mesh.bm1, np.float64)

        def bdot(a, b):  # <a, b>_B = sum conj(a) b bm1 over components
            return complex(np.sum(np.conj(a) * b * bm1[None]))

        nu1 = complex(res.multipliers[0])
        # match: w(nu) pairs with u(mu) iff nu = conj(mu)
        w_match = w1 if abs(np.conj(nu1) - mu_dir) <= abs(nu1 - mu_dir) else np.conj(w1)
        g_match = bdot(w_match, u1)
        g_cross = bdot(np.conj(w_match), u1)  # pairs with conj eigenvalue: must vanish
        norm_w = np.sqrt(abs(bdot(w_match, w_match)))
        norm_u = np.sqrt(abs(bdot(u1, u1)))
        ratio = abs(g_cross) / max(abs(g_match), 1e-300)
        out["biorthogonality"] = {
            "mu_direct": [mu_dir.real, mu_dir.imag],
            "nu_adjoint": [nu1.real, nu1.imag],
            "conj_pair_dev": abs(np.conj(nu1) - mu_dir),
            "g_match_abs_normalized": abs(g_match) / (norm_w * norm_u),
            "g_cross_over_g_match": ratio,
            "pass": bool(ratio < 1e-2),
        }
        print(f"biorthogonality: |<w,u_conj>|/|<w,u>| = {ratio:.3e} "
              f"(matched overlap {abs(g_match)/(norm_w*norm_u):.3f})", flush=True)

    print(json.dumps(out), flush=True)
    print(
        f"adjoint |mu1| = {out['mu1_abs']:.6f}  (oracle 1.0156 +- 1e-4; "
        f"in_band={out['in_band']}; {res.n_matvec} matvecs, {elapsed:.0f}s)",
        flush=True,
    )
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    if args.save_evec:
        w1 = res.eigenvectors[0]["u"]
        np.savez_compressed(
            args.save_evec,
            u_re=np.asarray(w1.real, np.float64),
            u_im=np.asarray(w1.imag, np.float64),
            mu1=np.asarray([mu1.real, mu1.imag]),
        )


if __name__ == "__main__":
    main()
