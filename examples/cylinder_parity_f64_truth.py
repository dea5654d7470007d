"""FLOAT64 subspace-iteration certificate for the cylinder parity eigenvalue.

The f32 runs give |mu1| = 1.015667 (direct) / 1.015730 (adjoint) and the
various one-shot f64 quotients disagree at the few-1e-5 level, so this
script computes the discrete operator's leading pair in f64 to a CERTIFIED
residual: subspace iteration V <- orth_B(M_f64 V) on the 2-dimensional real
invariant subspace seeded by the f32 direct eigenvector, with Rayleigh-Ritz
on the final subspace and the B-residual ||M v - mu v||_B reported. Each
iteration multiplies the eigenvector error by |mu3/mu1| ~ 0.75, and the
seed error is ~1e-3 at worst, so ~8 iterations certify ~1e-6.

This is the operator-truth anchor for the +-1e-4 oracle band
(/root/reference/test/neklabTests.py:43-45).

Usage:
    python examples/cylinder_parity_f64_truth.py --evec artifacts/dir_evec.npz \
        [--iters 8] [--out PARITY_r04_f64_truth.json]
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
    ap.add_argument("--evec", required=True, help="npz from --save-evec (f32 seed)")
    ap.add_argument("--adjoint", action="store_true",
                    help="iterate with the f64 ADJOINT operator (certifies "
                         "the adjoint-side eigenvalue; must equal the direct "
                         "one — same discrete spectrum)")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--tau", type=float, default=1.0)
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

    t0 = time.time()
    mesh = mesh_from_re2(f"{REF}/1cyl.re2", order=5, dealias_order=8, dtype=jnp.float64)
    bf = read_fld(f"{REF}/BF_1cyl0.f00001")
    base_u = jnp.asarray(bf.u, jnp.float64)
    fc = FlowConfig(viscosity=1.0 / 50.0, dt=1e9, vtol=1e-10, ptol=1e-9)
    cfg = LinConfig(flow=fc)
    expA = ExponentialPropagator(mesh, cfg, base_u, tau=args.tau, cfl=0.5)
    th = jnp.zeros((0,) + mesh.bm1.shape, jnp.float64)
    bm1 = np.asarray(mesh.bm1, np.float64)

    with np.load(args.evec) as z:
        v_re = np.asarray(z["u_re"], np.float64)
        v_im = np.asarray(z["u_im"], np.float64)

    def bdot(a, b):
        return float(np.sum(a * b * bm1[None]))

    def orth(V):
        # B-orthonormalize columns (modified Gram-Schmidt)
        out = []
        for v in V:
            for u in out:
                v = v - bdot(u, v) * u
            n = np.sqrt(bdot(v, v))
            out.append(v / n)
        return out

    apply_op = expA.rmatvec if args.adjoint else expA.matvec

    def mv(v):
        u = apply_op({"u": jnp.asarray(v), "theta": th})["u"]
        return np.asarray(u, np.float64)

    V = orth([v_re, v_im])
    n_mv = 0
    history = []
    for k in range(args.iters):
        W = [mv(v) for v in V]
        n_mv += len(V)
        # Rayleigh-Ritz on span(V): A_ij = <v_i, M v_j>_B
        A = np.array([[bdot(V[i], W[j]) for j in range(2)] for i in range(2)])
        evals, evecs = np.linalg.eig(A)
        i1 = int(np.argmax(np.abs(evals)))
        mu = complex(evals[i1])
        # residual of the Ritz pair: x = V c (complex), r = M x - mu x
        c = evecs[:, i1]
        x_re = c[0].real * V[0] + c[1].real * V[1]
        x_im = c[0].imag * V[0] + c[1].imag * V[1]
        Mx_re = c[0].real * W[0] + c[1].real * W[1]
        Mx_im = c[0].imag * W[0] + c[1].imag * W[1]
        r_re = Mx_re - (mu.real * x_re - mu.imag * x_im)
        r_im = Mx_im - (mu.real * x_im + mu.imag * x_re)
        xn = np.sqrt(bdot(x_re, x_re) + bdot(x_im, x_im))
        res = np.sqrt(bdot(r_re, r_re) + bdot(r_im, r_im)) / xn
        history.append({"iter": k, "mu_abs": abs(mu),
                        "mu": [mu.real, mu.imag], "residual_B": res})
        print(f"iter {k}: |mu| = {abs(mu):.8f}  residual_B = {res:.3e}", flush=True)
        V = orth(W)
        if res < 1e-9:
            break

    mu_abs = history[-1]["mu_abs"]
    out = {
        "case": ("CylEigsAdj" if args.adjoint else "CylEigs")
                + " f64 subspace-iteration truth (CPU, vtol 1e-10 / ptol 1e-9)",
        "adjoint": bool(args.adjoint),
        "oracle": {"mu1_abs": 1.0156, "delta": 1e-4},
        "seed": args.evec,
        "tau": args.tau, "dt": expA.dt, "nsteps": expA.nsteps,
        "mu1_abs": mu_abs,
        "mu1": history[-1]["mu"],
        "residual_B": history[-1]["residual_B"],
        "in_band": bool(abs(mu_abs - 1.0156) < 1e-4),
        "history": history,
        "n_matvec_f64": n_mv,
        "elapsed": time.time() - t0,
    }
    print(json.dumps(out), flush=True)
    print(f"f64 truth |mu1| = {mu_abs:.7f} (residual {out['residual_B']:.2e}, "
          f"in_band={out['in_band']})", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
