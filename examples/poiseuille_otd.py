"""Poiseuille OTD modes on a steady base flow — the reference's OTD_steady case.

Reference: /root/reference/examples/poiseuille/OTD_steady
(`poiseuille.usr:128-161`): r = lpert = 2 OTD modes co-evolved on the FROZEN
plane-Poiseuille base flow at Re = 5000 (poiseuille.par: viscosity -5000,
numberOfPerturbations 2, endTime 200, targetCFL 0.4), with
printstep=5 / orthostep=10 / iostep=500 / iorststep=500 — producing the
`Ls.dat` / `Lr.dat` reduced-spectrum time series.

Oracle (this framework adds one; the reference case is plot-checked only):
for a steady base the OTD subspace converges to the span of the r leading
eigenvectors of the linearized operator and eig(Lr) to its leading
eigenvalues. In the 2-pi periodic channel at Re=5000 the two leading modes
are the alpha=0 viscous shear modes with ANALYTIC rates

    sigma_m = -nu (m pi / 2)^2,  m = 1, 2,

(the Orr-Sommerfeld alpha=1 branch at Re=5000 is below them — computed here
with the independent Chebyshev OS solver for the artifact's comparison
table).

Outputs OTD_r04.json + Ls.dat/Lr.dat under --outdir.

Usage: python examples/poiseuille_otd.py [--re 5000] [--endtime 200]
           [--out OTD_r04.json] [--outdir artifacts/poiseuille_otd]
"""

import argparse
import json
import logging
import os
import sys
import time

logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--re", type=float, default=5000.0)
    ap.add_argument("--r", type=int, default=2, help="number of OTD modes (lpert)")
    ap.add_argument("--endtime", type=float, default=200.0)
    ap.add_argument("--cfl", type=float, default=0.4)
    ap.add_argument("--nelx", type=int, default=4)
    ap.add_argument("--nely", type=int, default=6)
    ap.add_argument("--order", type=int, default=6)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--trans", action="store_true", help="adjoint OTD evolution")
    ap.add_argument("--out", default=None)
    ap.add_argument("--outdir", default="artifacts/poiseuille_otd")
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.f64:
        jax.config.update("jax_enable_x64", True)
    from neklab_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    # An f32 matmul at default precision may round its inputs (TF32 on the
    # H100); over O(10^4) steps the truncation noise keeps re-exciting
    # decayed directions and contaminates the SLOWEST OTD mode's Rayleigh
    # quotient at the 1e-3 level (seen with bf16-rounded inputs at Re=500:
    # leading rate -0.00602 vs -0.00493 analytic, where a CPU f32 run
    # matches to 3e-6). Full-f32 matmuls fix it; negligible cost at this
    # problem size.
    jax.config.update("jax_default_matmul_precision", "float32")

    import numpy as np
    import jax.numpy as jnp

    from neklab_tpu.mesh.box import box_mesh
    from neklab_tpu.models.linearized import LinConfig
    from neklab_tpu.models.navier_stokes import FlowConfig, initial_state
    from neklab_tpu.models.precond import build_e_preconditioner
    from neklab_tpu.otd import OtdOpts, otd_analysis
    from neklab_tpu.utils.orr_sommerfeld import orr_sommerfeld_spectrum
    from neklab_tpu.utils.timestep import cfl_dt

    dtype = jnp.float64 if args.f64 else jnp.float32
    tols = dict(vtol=1e-11, ptol=1e-10) if args.f64 else dict(vtol=3e-7, ptol=3e-7)

    mesh = box_mesh(
        (args.nelx, args.nely), ((0.0, 2 * np.pi), (-1.0, 1.0)),
        {"x-": "P", "x+": "P", "y-": "W", "y+": "W"},
        order=args.order, dtype=dtype,
    )
    y = mesh.x[1]
    base_u = jnp.stack([1 - y**2, 0 * y])
    nu = 1.0 / args.re
    dt = float(cfl_dt(mesh, np.asarray(base_u), cfl=args.cfl))
    nsteps = int(round(args.endtime / dt))
    fc = FlowConfig(viscosity=nu, dt=dt, **tols)
    cfg = LinConfig(flow=fc)
    pc = build_e_preconditioner(mesh, dt / (11.0 / 6.0))
    print(f"mesh: {mesh.nel} elements, order {args.order}; "
          f"dt={dt:.5f} ({nsteps} steps to t={args.endtime})", flush=True)

    base = initial_state(mesh, fc, u=base_u)
    # reference cadences (poiseuille.usr opts): printstep 5, orthostep 10,
    # iostep 500, iorststep 500; steady base (solve_baseflow = .false.)
    opts = OtdOpts(r=args.r, startstep=1, printstep=5, orthostep=10,
                   iostep=500, iorststep=500, solve_baseflow=False,
                   trans=args.trans)

    t0 = time.time()
    res = otd_analysis(mesh, cfg, opts, base, nsteps=nsteps, pc_e=pc,
                       outdir=args.outdir)
    elapsed = time.time() - t0

    lam = np.sort(res.eigvals_lr.real)[::-1]
    # --- oracles ---
    shear = np.array([-(nu) * (m * np.pi / 2.0) ** 2 for m in range(1, args.r + 2)])
    os_a1 = orr_sommerfeld_spectrum(args.re, 1.0, n=160)
    # full-operator leading rates in the 2-pi box: union of alpha=0 shear
    # modes and the alpha=1 (and 2) OS branches
    os_a2 = orr_sommerfeld_spectrum(args.re, 2.0, n=160)
    pool = np.concatenate([shear, os_a1.real[:6], os_a2.real[:4]])
    expect = np.sort(pool)[::-1][: args.r]
    match_err = float(np.abs(lam[: args.r] - expect).max())

    out = {
        "case": "PoiseuilleOTDSteady",
        "reference": "examples/poiseuille/OTD_steady/poiseuille.usr:128-161 "
                     "(r=2, Re=5000, endTime=200, printstep 5 / orthostep 10 "
                     "/ iostep 500 / iorststep 500)",
        "re": args.re, "r": args.r, "endtime": args.endtime,
        "mesh": {"nelx": args.nelx, "nely": args.nely, "order": args.order},
        "dt": dt, "nsteps": nsteps,
        "platform": jax.devices()[0].platform,
        "dtype": str(getattr(dtype, "__name__", dtype)),
        "trans": bool(args.trans),
        "eig_lr": [[float(v.real), float(v.imag)] for v in res.eigvals_lr],
        "eig_lr_sym": [float(v) for v in res.eigvals_sym],
        "expected_leading": [float(v) for v in expect],
        "analytic_shear_modes": [float(v) for v in shear[: args.r]],
        "os_alpha1_leading": [float(v) for v in os_a1.real[:3]],
        "match_err": match_err,
        "n_printed": len(res.lr_history),
        "elapsed": elapsed,
        "outdir": args.outdir,
    }
    print(json.dumps(out), flush=True)
    print(f"eig(Lr) = {np.round(lam[:args.r], 6)} vs expected "
          f"{np.round(expect, 6)} (max err {match_err:.2e}; {elapsed:.0f}s)",
          flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
