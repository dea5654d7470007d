"""Float64 ADJOINT-side eigenvalue certification by seeded Krylov-Schur.

Round-4 left the adjoint parity out of band: the 2-dim f64 subspace iteration
(PARITY_r04_adj_f64_truth.json) stagnated at residual ~9e-6, which at
kappa(mu) ~ 40 bounds the eigenvalue only to ~4e-4 — not enough to certify
the 1.0156 +- 1e-4 oracle band. Subspace iteration converges at the
|mu_3/mu_1| exterior gap; a Krylov subspace seeded with the same vector
resolves the nearby decaying modes and pushes the Ritz residual to the
solver floor in one or two cycles.

Method: f64 CPU Arnoldi (Krylov-Schur, krylov/eigs.py) on M* with
  * adjoint_tol_factor = 1.0 — M* is then the EXACT linear transpose of the
    forward f64 program (identical spectrum by construction; transposition
    preserves eigenvalues), so the certified adjoint value must reproduce
    the direct-side truth 1.0156835 (PARITY_r04_f64_truth.json);
  * inner tolerances vtol 1e-10 / ptol 1e-9 (the direct truth's);
  * v0 = Re(w1_f32) from the f32 adjoint Arnoldi (--save-evec npz).

Certificate: residual_B < tol ==> |delta mu| <~ kappa * tol = 40 * tol.
tol = 1.5e-6 gives 6e-5 < the 1e-4 band half-width.

Reference oracle: adjoint spectrum = conj(direct);
/root/reference/examples/cylinder/stability/adjoint/1cyl.usr:21 and
/root/reference/test/neklabTests.py:43-45 (|mu1| = 1.0156 +- 1e-4).

Usage:
    python examples/cylinder_parity_adjoint_f64_arnoldi.py \
        --evec artifacts/adj_evec2.npz --out PARITY_r05_adj_f64_truth.json \
        --checkpoint artifacts/ckpt_adj_f64.npz
"""

import argparse
import json
import logging
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")

REF = "/root/reference/examples/cylinder/stability/adjoint"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--evec", required=True)
    ap.add_argument("--tau", type=float, default=1.0)
    ap.add_argument("--kdim", type=int, default=24)
    ap.add_argument("--nev", type=int, default=2)
    ap.add_argument("--tol", type=float, default=1.5e-6)
    ap.add_argument("--maxiter", type=int, default=8)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from neklab_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import numpy as np
    import jax.numpy as jnp

    from neklab_tpu.krylov.eigs import eigs
    from neklab_tpu.linops.exponential_propagator import ExponentialPropagator
    from neklab_tpu.mesh.re2 import mesh_from_re2
    from neklab_tpu.models.linearized import LinConfig
    from neklab_tpu.models.navier_stokes import FlowConfig
    from neklab_tpu.utils.fldfile import read_fld
    from neklab_tpu.vectors import flow_vector_space, project_c0

    t0 = time.time()
    mesh = mesh_from_re2(f"{REF}/1cyl.re2", order=5, dealias_order=8, dtype=jnp.float64)
    bf = read_fld(f"{REF}/BF_1cyl0.f00001")
    base_u = jnp.asarray(bf.u, jnp.float64)
    fc = FlowConfig(viscosity=1.0 / 50.0, dt=1e9, vtol=1e-10, ptol=1e-9)
    cfg = LinConfig(flow=fc)
    expA = ExponentialPropagator(mesh, cfg, base_u, tau=args.tau, cfl=0.5,
                                 adjoint_tol_factor=1.0)
    print(f"propagator: dt={expA.dt:.6e}, nsteps={expA.nsteps}", flush=True)
    space = flow_vector_space(mesh, 0)
    th0 = jnp.zeros((0,) + mesh.bm1.shape, jnp.float64)

    with np.load(args.evec) as z:
        v0 = project_c0(mesh, {"u": jnp.asarray(np.asarray(z["u_re"], np.float64)),
                               "theta": th0})

    res = eigs(
        expA, space, nev=args.nev, kdim=args.kdim, tol=args.tol,
        maxiter=args.maxiter, which="lm", adjoint=True, v0=v0,
        checkpoint=args.checkpoint, checkpoint_every=4, check_every=4,
    )
    mu1 = complex(res.eigvals[0])
    lam = np.log(mu1) / args.tau
    elapsed = time.time() - t0
    kappa = 40.0  # biorthogonal-overlap estimate, RESULTS_r04.md
    out = {
        "case": "CylEigsAdj f64 seeded Krylov-Schur certification (CPU)",
        "adjoint": True,
        "oracle": {"mu1_abs": 1.0156, "delta": 1e-4,
                   "source": "adjoint spectrum = conj(direct); "
                             "examples/cylinder/stability/adjoint/1cyl.usr:21"},
        "setup": {"tau": args.tau, "dt": expA.dt, "nsteps": expA.nsteps,
                  "vtol": 1e-10, "ptol": 1e-9, "adjoint_tol_factor": 1.0,
                  "kdim": args.kdim, "nev": args.nev, "tol": args.tol,
                  "dtype": "float64", "platform": "cpu",
                  "seed_vector": args.evec},
        "mu1_abs": float(abs(mu1)),
        "mu1": [mu1.real, mu1.imag],
        "sigma": float(lam.real),
        "omega": float(abs(lam.imag)),
        "residual_B": float(res.residuals[0]),
        "eigenvalue_error_bound": float(kappa * res.residuals[0]),
        "in_band": bool(abs(abs(mu1) - 1.0156) < 1e-4),
        "direct_f64_truth": 1.015683466023729,
        "agrees_with_direct_truth": bool(
            abs(abs(mu1) - 1.015683466023729) < kappa * max(res.residuals[0], args.tol)),
        "n_rmatvec": res.n_matvec,
        "elapsed": elapsed,
    }
    print(json.dumps(out), flush=True)
    print(f"adjoint f64 |mu1| = {abs(mu1):.7f} (residual {res.residuals[0]:.2e}, "
          f"in_band={out['in_band']}, {elapsed:.0f}s)", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
