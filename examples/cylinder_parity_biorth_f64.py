"""Two-sided (biorthogonal) Rayleigh-quotient certification of |mu1| in f64.

For approximate RIGHT eigenvector z (residual r_z = ||M z - mu z||_B) and
LEFT eigenvector w (adjoint Ritz vector, residual r_w), the two-sided
quotient  rho = <w, M z>_B / <w, z>_B  has error

    |rho - mu| <= r_w * r_z / |<w, z>_B|  + higher order,

QUADRATIC in the residuals — with r_w ~ 8.5e-6 (from the f64 adjoint Arnoldi
factorization, exact bound) and r_z ~ 1e-5 (f32-seeded right vector measured
under the f64 operator), the bound is ~1e-8-1e-9: far tighter than the
kappa*r ~ 3e-4 one-sided bounds that floored rounds 3-5.

Inputs: the live/final f64 adjoint Arnoldi checkpoint (left vector = V y)
and the f32 direct eigenvector npz (right vector). One extra f64 matvec
(M z) + one f64 rmatvec-free residual evaluation.

Reference oracle: |mu1| = 1.0156 +- 1e-4
(/root/reference/test/neklabTests.py:43-45).

Usage:
    python examples/cylinder_parity_biorth_f64.py \
        --ckpt artifacts/ckpt_adj_f64.npz --evec artifacts/dir_evec.npz \
        --out PARITY_r05_biorth_f64.json
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
    ap.add_argument("--ckpt", default="artifacts/ckpt_adj_f64.npz")
    ap.add_argument("--evec", default="artifacts/dir_evec.npz")
    ap.add_argument("--tau", type=float, default=1.0)
    ap.add_argument("--dt-div", type=float, default=1.0,
                    help="divide the CFL-derived dt by this factor (dt-"
                         "refinement study: quantifies the time-discretization "
                         "sensitivity of mu1; the seed vectors' residuals "
                         "grow to ~operator-difference size, still giving a "
                         "~1e-5 two-sided bound — enough to resolve 1e-4 "
                         "shifts)")
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
    from neklab_tpu.vectors import project_c0

    t0 = time.time()
    mesh = mesh_from_re2(f"{REF}/1cyl.re2", order=5, dealias_order=8, dtype=jnp.float64)
    bf = read_fld(f"{REF}/BF_1cyl0.f00001")
    base_u = jnp.asarray(bf.u, jnp.float64)
    fc = FlowConfig(viscosity=1.0 / 50.0, dt=1e9, vtol=1e-10, ptol=1e-9)
    cfg = LinConfig(flow=fc)
    from neklab_tpu.utils.timestep import cfl_dt, clamp_cfl

    dt0 = cfl_dt(mesh, base_u, cfl=clamp_cfl(0.5))
    expA = ExponentialPropagator(mesh, cfg, base_u, tau=args.tau,
                                 dt=float(dt0) / args.dt_div,
                                 adjoint_tol_factor=1.0)
    th0 = jnp.zeros((0,) + mesh.bm1.shape, jnp.float64)
    bm1 = np.asarray(mesh.bm1)

    def bdot(a, b):  # complex B-inner product <a, b> = sum conj(a) b bm1
        return np.sum(np.conj(a) * b * bm1[None])

    def bnorm(a):
        return float(np.sqrt(abs(bdot(a, a))))

    # ---- LEFT vector: leading Ritz pair of the adjoint Arnoldi checkpoint
    with np.load(args.ckpt) as z:
        H = np.asarray(z["H"])
        vk = int(z["vk"])
        # basis leaves are tree_leaves of {"theta": ..., "u": ...} (dict-key
        # sorted): pick the velocity stack = the largest leaf
        leaves = [np.asarray(z[n]) for n in z.files if n.startswith("leaf_")]
        Vu = max(leaves, key=lambda a: a.size)
    k = vk - 1
    Hk = H[:k, :k]
    beta = H[k, k - 1]
    evals, evecs = np.linalg.eig(Hk)
    i1 = int(np.argmax(np.abs(evals)))
    mu_w = complex(evals[i1])
    y = evecs[:, i1]
    r_w = float(abs(beta * y[k - 1]))  # exact Arnoldi residual bound (B-norm)
    w = np.tensordot(y, Vu[:k], axes=(0, 0))  # complex left eigenvector
    w = w / bnorm(w)

    # ---- RIGHT vector: f32 direct eigenvector, projected + f64
    with np.load(args.evec) as z:
        z_re = np.asarray(z["u_re"], np.float64)
        z_im = np.asarray(z["u_im"], np.float64)
    pc0 = lambda a: np.asarray(project_c0(mesh, {"u": jnp.asarray(a), "theta": th0})["u"])
    zc = pc0(z_re) + 1j * pc0(z_im)
    zc = zc / bnorm(zc)

    # ---- one f64 matvec on each real/imag part
    mv = lambda a: np.asarray(expA.matvec({"u": jnp.asarray(a), "theta": th0})["u"])
    Mz = mv(zc.real) + 1j * mv(zc.imag)
    n_mv = 2

    # right residual under the f64 operator (Rayleigh quotient for mu_z)
    mu_z = bdot(zc, Mz) / bdot(zc, zc)
    r_z = bnorm(Mz - mu_z * zc)

    # ---- two-sided quotient. NOTE the left eigenvector of M pairs with
    # right eigenvectors of conj eigenvalue: use conj as needed — select the
    # pairing that maximizes |<w, z>|.
    s1 = bdot(w, zc)
    s2 = bdot(np.conj(w), zc)
    w_use = w if abs(s1) >= abs(s2) else np.conj(w)
    s = bdot(w_use, zc)
    rho = bdot(w_use, Mz) / s
    bound = r_w * r_z / abs(s)

    out = {
        "case": "CylEigs f64 two-sided Rayleigh-quotient certification (CPU)",
        "oracle": {"mu1_abs": 1.0156, "delta": 1e-4,
                   "source": "test/neklabTests.py:43-45"},
        "method": "rho = <w, M z>_B / <w, z>_B; |rho - mu| <= r_w r_z / |<w,z>| "
                  "(quadratic in residuals). w = leading Ritz vector of the "
                  "seeded f64 adjoint Arnoldi (residual exact from the "
                  "factorization); z = f32 direct eigenvector re-projected, "
                  "residual re-measured under the f64 operator.",
        "setup": {"tau": args.tau, "dt": expA.dt, "nsteps": expA.nsteps, "dt_div": args.dt_div,
                  "vtol": 1e-10, "ptol": 1e-9, "adjoint_tol_factor": 1.0,
                  "dtype": "float64", "platform": "cpu"},
        "mu1_abs": float(abs(rho)),
        "mu1": [rho.real, rho.imag],
        "sigma": float(np.log(rho).real),
        "omega": float(abs(np.log(rho).imag)),
        "left_residual_B": r_w,
        "right_residual_B": r_z,
        "overlap_s": abs(s),
        "kappa_measured": float(1.0 / abs(s)),
        "error_bound": float(bound),
        "adjoint_ritz_mu_abs": abs(mu_w),
        "right_rayleigh_mu_abs": float(abs(mu_z)),
        "in_band": bool(abs(abs(rho) - 1.0156) < 1e-4),
        "n_matvec_f64": n_mv,
        "elapsed": time.time() - t0,
    }
    print(json.dumps(out, indent=1), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
