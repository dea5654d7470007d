"""Plane-Poiseuille linear stability (Orr-Sommerfeld spectrum).

Reference case: examples/poiseuille/stability/direct (Re=7500, kdim=128,
nev=20 — SURVEY section 6). The leading eigenvalues of exp(tau A) are mapped
back by log(mu)/tau and compared against an independently computed Chebyshev
Orr-Sommerfeld spectrum.

Usage: python examples/poiseuille_stability.py [--preset coarse|medium|fine]
                                               [--re 7500] [--alpha 1.0]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


# Resolution note: Re=7500 critical layers need ~>55^2 points in 2-D;
# smaller grids produce spurious unstable alpha=2 modes.
PRESETS = {
    #         nelx nely order tau   kdim nev
    "coarse": (8, 8, 7, 0.5, 64, 6),
    "medium": (12, 10, 8, 0.5, 96, 10),
    "fine": (16, 12, 9, 0.5, 128, 20),
}


def os_oracle(re, alpha):
    """Leading eigenvalue of the periodic box [0, 2 pi / alpha] x [-1, 1]:
    the largest growth rate over its harmonics 0 (shear modes), alpha and
    2 alpha, from the Chebyshev Orr-Sommerfeld solver."""
    import numpy as np

    from neklab_tpu.utils.orr_sommerfeld import (
        orr_sommerfeld_spectrum,
        shear_mode_eigenvalues,
    )

    cand = np.concatenate([
        shear_mode_eigenvalues(re, 4).astype(complex),
        orr_sommerfeld_spectrum(re, alpha, 128)[:6],
        orr_sommerfeld_spectrum(re, 2 * alpha, 128)[:6],
    ])
    return cand[np.argmax(cand.real)]


def run(preset="medium", re=7500.0, alpha=1.0, f64=False):
    """Krylov-Schur eigensolve of exp(tau A) about plane Poiseuille flow;
    returns the result record. preset: a PRESETS name or a tuple of the same
    fields."""
    import numpy as np
    import jax.numpy as jnp

    from neklab_tpu.analysis import linear_stability_analysis_fixed_point
    from neklab_tpu.linops.exponential_propagator import ExponentialPropagator
    from neklab_tpu.mesh.box import box_mesh
    from neklab_tpu.models.linearized import LinConfig
    from neklab_tpu.models.navier_stokes import FlowConfig
    from neklab_tpu.vectors import flow_vector_space

    nelx, nely, order, tau, kdim, nev = (
        PRESETS[preset] if isinstance(preset, str) else preset)
    dtype = jnp.float64 if f64 else jnp.float32
    tols = dict(vtol=1e-12, ptol=1e-12) if f64 else dict(vtol=1e-7, ptol=1e-7)

    lx = 2 * np.pi / alpha
    mesh = box_mesh(
        (nelx, nely), ((0, lx), (-1, 1)),
        {"x-": "P", "x+": "P", "y-": "W", "y+": "W"}, order=order, dtype=dtype,
    )
    cfg = LinConfig(flow=FlowConfig(viscosity=1 / re, dt=2e-3, **tols))
    y = mesh.x[1]
    U = jnp.stack([1 - y**2, 0 * y])
    expA = ExponentialPropagator(mesh, cfg, U, tau=tau, cfl=0.5)
    space = flow_vector_space(mesh, 0)

    t0 = time.time()
    res = linear_stability_analysis_fixed_point(
        expA, space, kdim=kdim, nev=nev, tol=1e-6, maxiter=10
    )
    elapsed = time.time() - t0

    oracle = os_oracle(re, alpha)
    lead = res.eigvals[0]
    # eigenvalues of the real operator come in conjugate pairs
    err = min(abs(lead - oracle), abs(lead - np.conj(oracle)))
    return {
        "case": "poiseuille_stability",
        "re": re,
        "alpha": alpha,
        "preset": preset,
        "nsteps_per_matvec": expA.nsteps,
        "eigvals": [[v.real, v.imag] for v in res.eigvals],
        "sigma1": float(lead.real),
        "os_leading": [float(oracle.real), float(oracle.imag)],
        "os_match_err": float(err),
        "n_matvec": res.n_matvec,
        "seconds": elapsed,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="medium", choices=sorted(PRESETS))
    ap.add_argument("--re", type=float, default=7500.0)
    ap.add_argument("--alpha", type=float, default=1.0, help="streamwise wavenumber of the box")
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

    out = run(args.preset, re=args.re, alpha=args.alpha, f64=args.f64)
    print(json.dumps(out), flush=True)
    print(f"sigma1 = {out['sigma1']:.6f}  (OS oracle {out['os_leading'][0]:.6f}); "
          f"match error {out['os_match_err']:.2e}", flush=True)


if __name__ == "__main__":
    main()
