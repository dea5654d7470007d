"""Float64 refinement of the parity eigenvalue + f32-vs-f64 drift table.

The full kdim=128 reference-condition Arnoldi runs in f32 on the device
(cylinder_parity.py). This script re-converges the leading eigenpair in
FLOAT64 on CPU by Rayleigh-Ritz on the subspace spanned by the f32
eigenvector pair AND its image under the f64 operator:

    V  = B-orth{Re v1, Im v1}            (the f32 invariant pair, ~1e-5 off)
    V+ = B-orth{V, M V}                  (folds in the first-order error)
    mu = eig( V+^T B M V+ )              (4 f64 matvecs at tau=1.0 total)

with the B-residual ||M z - mu z||_B reported for the reconstructed complex
eigenvector (the certificate that the Ritz value is converged). Same
discrete operator and reference tolerances (vtol 1e-9 / ptol 1e-7,
1cyl.par:22-28). Output: the f64 |mu1| against the published band
1.0156 +- 1e-4 AND the measured f32 drift (VERDICT round-1 items 1-2).

Usage:
    python examples/cylinder_parity_refine.py --evec /tmp/parity_evec.npz \
        --out PARITY_r02_f64.json
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
    ap.add_argument("--evec", required=True, help="npz from cylinder_parity.py --save-evec")
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
    from neklab_tpu.vectors import flow_vector_space, project_c0

    mesh = mesh_from_re2(f"{REF}/1cyl.re2", order=5, dealias_order=8, dtype=jnp.float64)
    bf = read_fld(f"{REF}/BF_1cyl0.f00001")
    base_u = jnp.asarray(bf.u)

    fc = FlowConfig(viscosity=1.0 / 50.0, dt=1e9, vtol=1e-9, ptol=1e-7)
    cfg = LinConfig(flow=fc)
    expA = ExponentialPropagator(mesh, cfg, base_u, tau=args.tau, cfl=0.5)
    print(f"propagator: dt={expA.dt:.6e}, nsteps={expA.nsteps}", flush=True)
    space = flow_vector_space(mesh, 0)

    with np.load(args.evec) as z:
        u_re, u_im = z["u_re"], z["u_im"]
        mu1_f32 = complex(z["mu1"][0], z["mu1"][1])

    th0 = jnp.zeros((0,) + mesh.bm1.shape, jnp.float64)
    mk = lambda u: project_c0(mesh, {"u": jnp.asarray(u, jnp.float64), "theta": th0})

    def orth(vs, w):
        """B-orthonormalize w against list vs (CGS2); unit w or None."""
        for _ in range(2):
            for v in vs:
                w = {"u": w["u"] - float(space.dot_fn(v, w)) * v["u"], "theta": th0}
        nrm = float(np.sqrt(space.dot_fn(w, w)))
        if nrm < 1e-14:
            return None
        return {"u": w["u"] / nrm, "theta": th0}

    t0 = time.time()
    basis = []
    for u in (u_re, u_im):
        w = orth(basis, mk(u))
        if w is not None:
            basis.append(w)
    images = [expA.matvec(v) for v in basis]  # 2 f64 matvecs
    for w in list(images):
        w2 = orth(basis, {"u": w["u"], "theta": th0})
        if w2 is not None:
            basis.append(w2)
    # images of the added directions (2 more matvecs)
    images += [expA.matvec(v) for v in basis[len(images):]]
    n_mv = len(images)

    m = len(basis)
    A = np.zeros((m, m))
    for i in range(m):
        for j in range(m):
            A[i, j] = float(space.dot_fn(basis[i], images[j]))
    evals, evecs = np.linalg.eig(A)
    order = np.argsort(-np.abs(evals))
    mu1 = evals[order[0]]
    c = evecs[:, order[0]]

    # residual certificate ||M z - mu z||_B for the reconstructed eigenvector
    z_u = sum(ci * np.asarray(b["u"]) for ci, b in zip(c, basis))
    Mz_u = sum(ci * np.asarray(w["u"]) for ci, w in zip(c, images))
    r_u = Mz_u - mu1 * z_u
    bm1 = np.asarray(mesh.bm1)
    bnorm = lambda f: float(np.sqrt(abs(np.sum(np.conj(f) * f * bm1))))
    res = bnorm(r_u) / max(bnorm(z_u), 1e-300)
    elapsed = time.time() - t0

    lam = np.log(complex(mu1)) / args.tau
    out = {
        "case": "CylEigsDir f64 Rayleigh-Ritz refinement (reference data)",
        "method": "4-dim B-orthonormal Rayleigh-Ritz on span{v_f32, M_f64 v_f32}",
        "oracle": {"mu1_abs": 1.0156, "delta": 1e-4},
        "setup": {"tau": args.tau, "dt": expA.dt, "nsteps": expA.nsteps,
                  "vtol": 1e-9, "ptol": 1e-7, "dtype": "float64", "platform": "cpu"},
        "mu1_abs": float(np.abs(mu1)),
        "mu1": [float(mu1.real), float(mu1.imag)],
        "in_band": bool(abs(float(np.abs(mu1)) - 1.0156) < 1e-4),
        "sigma": float(lam.real),
        "omega": float(abs(lam.imag)),
        "residual_B": res,
        "n_matvec": n_mv,
        "elapsed": elapsed,
        "f32_vs_f64": {
            "mu1_abs_f32": float(np.abs(mu1_f32)),
            "mu1_abs_f64": float(np.abs(mu1)),
            "drift_abs": float(abs(np.abs(mu1_f32) - np.abs(mu1))),
        },
    }
    print(json.dumps(out), flush=True)
    print(
        f"f64 |mu1| = {out['mu1_abs']:.7f} (in_band={out['in_band']}, "
        f"residual {res:.2e}); f32 drift = {out['f32_vs_f64']['drift_abs']:.2e}",
        flush=True,
    )
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
