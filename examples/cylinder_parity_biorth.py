"""Biorthogonal Rayleigh-quotient certificate for the adjoint parity pair.

The leading eigenvalue of the cylinder propagator is ill-conditioned
(kappa(mu) ~ 1/|<w,u>| ~ 40, biorthogonal overlap 0.025), so plain Ritz
values from either the direct or adjoint Arnoldi carry O(kappa * residual)
~1e-4 error — exactly the band width. The biorthogonal quotient

    mu = <w, M u>_B / <w, u>_B

with u the direct and w the matching adjoint eigenvector is SECOND-ORDER
accurate: error = O(||r_u|| ||r_w|| / |<w,u>|) ~ 2e-9 here. Evaluated with
the FLOAT64 operator (one f64 matvec), this certifies both parity runs
against the published band and quantifies the adjoint consistency of the
discrete operator pair.

Usage:
    python examples/cylinder_parity_biorth.py \
        --direct-evec .scratch/dir_evec.npz --adjoint-evec artifacts/adj_evec.npz \
        --out PARITY_r04_biorth.json
"""

import argparse
import json
import logging
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")

REF = "/root/reference/examples/cylinder/stability/direct"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--direct-evec", required=True)
    ap.add_argument("--adjoint-evec", required=True)
    ap.add_argument("--tau", type=float, default=1.0)
    ap.add_argument("--cfl", type=float, default=0.5)
    ap.add_argument("--pextrap", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from neklab_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import numpy as np
    import jax.numpy as jnp

    from neklab_tpu.linops.exponential_propagator import ExponentialPropagator
    from neklab_tpu.mesh.re2 import mesh_from_re2
    from neklab_tpu.models.linearized import LinConfig
    from neklab_tpu.models.navier_stokes import FlowConfig
    from neklab_tpu.utils.fldfile import read_fld

    mesh = mesh_from_re2(f"{REF}/1cyl.re2", order=5, dealias_order=8, dtype=jnp.float64)
    bf = read_fld(f"{REF}/BF_1cyl0.f00001")
    base_u = jnp.asarray(bf.u)
    fc = FlowConfig(viscosity=1.0 / 50.0, dt=1e9, vtol=1e-9, ptol=1e-7,
                    pextrap=args.pextrap)
    cfg = LinConfig(flow=fc)
    expA = ExponentialPropagator(mesh, cfg, base_u, tau=args.tau, cfl=args.cfl)
    th0 = jnp.zeros((0,) + mesh.bm1.shape, jnp.float64)
    bm1 = np.asarray(mesh.bm1)

    with np.load(args.direct_evec) as z:
        u1 = z["u_re"] + 1j * z["u_im"]
        mu_dir = complex(z["mu1"][0], z["mu1"][1])
    with np.load(args.adjoint_evec) as z:
        w1 = z["u_re"] + 1j * z["u_im"]
        nu_adj = complex(z["mu1"][0], z["mu1"][1])

    def bdot(a, b):
        return complex(np.sum(np.conj(a) * b * bm1[None]))

    t0 = time.time()
    # one f64 forward matvec on re/im parts of u1
    Mu_re = np.asarray(expA.matvec({"u": jnp.asarray(u1.real), "theta": th0})["u"])
    Mu_im = np.asarray(expA.matvec({"u": jnp.asarray(u1.imag), "theta": th0})["u"])
    Mu = Mu_re + 1j * Mu_im

    # pick the conjugation of w that pairs with u (largest overlap)
    cands = {"w": w1, "conj(w)": np.conj(w1)}
    key = max(cands, key=lambda k: abs(bdot(cands[k], u1)))
    w = cands[key]
    overlap = bdot(w, u1)
    mu_bi = bdot(w, Mu) / overlap
    # plain (direct) Rayleigh quotient for comparison: first-order accurate
    mu_rq = bdot(u1, Mu) / bdot(u1, u1)
    elapsed = time.time() - t0

    norm_u = np.sqrt(abs(bdot(u1, u1)))
    norm_w = np.sqrt(abs(bdot(w, w)))
    out = {
        "case": "Cyl biorthogonal Rayleigh-quotient certificate (f64 operator)",
        "oracle": {"mu1_abs": 1.0156, "delta": 1e-4},
        "method": "mu = <w, M_f64 u>_B / <w, u>_B with f32 (u, w) pairs; "
                  "error O(r_u r_w / overlap)",
        "setup": {"tau": args.tau, "dt": expA.dt, "nsteps": expA.nsteps, "cfl": args.cfl, "pextrap": args.pextrap,
                  "vtol": 1e-9, "ptol": 1e-7, "dtype": "float64"},
        "pairing": key,
        "overlap_normalized": abs(overlap) / (norm_u * norm_w),
        "mu1_abs": float(abs(mu_bi)),
        "mu1": [mu_bi.real, mu_bi.imag],
        "in_band": bool(abs(abs(mu_bi) - 1.0156) < 1e-4),
        "mu_direct_ritz_f32": [mu_dir.real, mu_dir.imag],
        "mu_adjoint_ritz_f32": [nu_adj.real, nu_adj.imag],
        "mu_plain_rayleigh_f64": [mu_rq.real, mu_rq.imag],
        "eigenvalue_condition_estimate": float((norm_u * norm_w) / abs(overlap)),
        "n_matvec_f64": 2,
        "elapsed": elapsed,
    }
    print(json.dumps(out), flush=True)
    print(f"biorthogonal |mu1| = {out['mu1_abs']:.7f} (in_band={out['in_band']}; "
          f"kappa(mu) ~ {out['eigenvalue_condition_estimate']:.0f})", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
