"""Cylinder-wake periodic orbit (UPO) + Floquet analysis.

Reference analog: examples/cylinder/newton/Re180_periodic_orbit (period guess
T0 = 5.158, BASELINE.md). Pipeline:
  1. DNS into the vortex-shedding limit cycle;
  2. period estimate from a wake velocity probe (zero crossings);
  3. Newton on the (X, T) UPO system (exact jvp monodromy + phase condition);
  4. Floquet multipliers of the converged orbit via Arnoldi on the monodromy.

Defaults are the REFERENCE conditions: Re=180, T0 ~ 5.158
(/root/reference/examples/cylinder/newton/Re180_periodic_orbit/1cyl.usr:24).
Parity recipe (f32 Newton, then f64 refinement to tol <= 1e-6):

  python examples/cylinder_upo.py --save-state upo_f32.npz --out UPO_f32.json
  python examples/cylinder_upo.py --platform cpu --f64 --init-state upo_f32.npz \
      --out UPO_r04.json

Usage: python examples/cylinder_upo.py [--re 180] [--platform cpu] [--f64]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--re", type=float, default=180.0)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--save-state", default=None,
                    help="save the converged orbit (u, p, T) as .npz")
    ap.add_argument("--init-state", default=None,
                    help="start Newton from a saved orbit (skips the DNS "
                         "spin-up and period estimation) — the f32->f64 "
                         "refinement path")
    ap.add_argument("--nel-r", type=int, default=7)
    ap.add_argument("--nel-t", type=int, default=18)
    ap.add_argument("--rout", type=float, default=15.0)
    ap.add_argument("--order", type=int, default=5)
    ap.add_argument("--dt", type=float, default=0.01)
    ap.add_argument("--spin-chunks", type=int, default=400)
    ap.add_argument("--newton-tol", type=float, default=None,
                    help="override Newton tolerance (default 3e-4 f32 / 1e-7 f64)")
    ap.add_argument("--newton-maxiter", type=int, default=20)
    ap.add_argument("--floquet-kdim", type=int, default=32)
    ap.add_argument("--floquet-tol", type=float, default=None)
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

    from neklab_tpu import (
        FlowConfig,
        LinConfig,
        MonodromyOperator,
        PeriodicOrbitSystem,
        annulus_mesh,
        eigs,
        ext_flow_vector,
        ext_flow_vector_space,
        newton_fixed_point_iteration,
    )
    from neklab_tpu.models.navier_stokes import advance, initial_state
    from neklab_tpu.models.precond import build_e_preconditioner

    dtype = jnp.float64 if args.f64 else jnp.float32
    tols = dict(vtol=1e-10, ptol=1e-9) if args.f64 else dict(vtol=3e-6, ptol=3e-6)
    mesh = annulus_mesh(args.nel_r, args.nel_t, r_in=0.5, r_out=args.rout,
                        order=args.order, grading=1.5,
                        outer_bc="vO", shift=0.25, dtype=dtype)
    dt = args.dt
    fc = FlowConfig(viscosity=1 / args.re, dt=dt, **tols)
    cfg = LinConfig(flow=fc)
    pc = build_e_preconditioner(mesh, dt / (11 / 6))

    r = jnp.sqrt(mesh.x[0] ** 2 + mesh.x[1] ** 2)
    free = (r > 0.5 + 1e-8).astype(dtype)
    ub = jnp.stack([free, jnp.zeros_like(free)])
    ramp = 1 - jnp.exp(-3.0 * (r - 0.5))
    # asymmetric kick so shedding develops quickly
    kick = 0.1 * jnp.exp(-((mesh.x[0] - 1.5) ** 2 + (mesh.x[1] - 0.5) ** 2))
    u0 = jnp.stack([ramp, kick])
    st = initial_state(mesh, fc, u=mesh.vmask * u0 + (1 - mesh.vmask) * ub)

    if args.init_state:
        # resume from a previously converged (e.g. f32) orbit: skip spin-up
        with np.load(args.init_state) as z:
            u_init = jnp.asarray(z["u"], dtype)
            period0 = float(z["T"])
        print(f"init from {args.init_state}: T0 = {period0:.5f}", flush=True)
        x0_u = u_init
    else:
        # 1. into the limit cycle, tracking a wake probe
        xx = np.asarray(mesh.x[0]); yy = np.asarray(mesh.x[1])
        probe = np.unravel_index(np.argmin((xx - 2.0) ** 2 + (yy - 0.3) ** 2), xx.shape)
        chunk, nchunks = 25, args.spin_chunks
        trace = []
        t0 = time.time()
        for _ in range(nchunks):
            st = advance(mesh, fc, st, chunk, ub=ub, pc_e=pc)
            trace.append(float(st.u[1][probe]))
        print(f"DNS to t={float(st.time):.1f} in {time.time()-t0:.0f}s", flush=True)

        # 2. period from the last zero-up-crossings of the probe signal
        sig = np.array(trace) - np.mean(trace[-120:])
        ts = np.arange(1, nchunks + 1) * chunk * dt
        ups = [
            ts[i] - sig[i] * (ts[i + 1] - ts[i]) / (sig[i + 1] - sig[i])
            for i in range(len(sig) - 1)
            if sig[i] < 0 <= sig[i + 1]
        ]
        if len(ups) < 3:
            raise SystemExit("no shedding detected — increase DNS time or the kick")
        period0 = float(np.mean(np.diff(ups[-4:])))
        print(f"estimated period T0 = {period0:.4f}", flush=True)
        x0_u = st.u

    # 3. Newton on the UPO system
    sysm = PeriodicOrbitSystem(mesh, cfg, t_guess=period0, ub=ub)
    space = ext_flow_vector_space(mesh, 0)
    x0 = ext_flow_vector(mesh, 0, u=x0_u, T=period0)
    newton_tol = args.newton_tol if args.newton_tol is not None else (1e-7 if args.f64 else 3e-4)
    t0 = time.time()
    nres = newton_fixed_point_iteration(sysm, x0, space, tol=newton_tol,
                                        maxiter=args.newton_maxiter, gmres_kdim=40)
    print(
        f"UPO newton: converged={nres.converged} |F|={nres.residual_norm:.3e} "
        f"T={float(nres.x['T']):.5f} ({time.time()-t0:.0f}s)",
        flush=True,
    )
    if args.save_state:
        np.savez(args.save_state, u=np.asarray(nres.x["u"]), T=float(nres.x["T"]))
        print(f"saved orbit to {args.save_state}", flush=True)

    # 4. Floquet multipliers of the orbit
    from neklab_tpu import flow_vector_space

    mono = MonodromyOperator(sysm, nres.x)
    fspace = flow_vector_space(mesh, 0)
    t0 = time.time()
    ftol = args.floquet_tol if args.floquet_tol is not None else (1e-5 if not args.f64 else 1e-7)
    eres = eigs(mono, fspace, nev=3, kdim=args.floquet_kdim, tol=ftol, maxiter=8)
    mus = eres.eigvals
    print(f"Floquet multipliers: {np.round(mus, 5)} ({time.time()-t0:.0f}s)", flush=True)
    print("|mu| =", np.abs(mus), " (a neutral multiplier ~1.0 must exist: phase mode)")

    out = {
        "re": args.re,
        "mesh": {"nel": mesh.nel, "order": args.order, "r_out": args.rout},
        "dt": dt,
        "period_guess_T0": period0,
        "period": float(nres.x["T"]),
        "newton_converged": bool(nres.converged),
        "newton_residual": float(nres.residual_norm),
        "newton_history": [float(h) for h in nres.history],
        "floquet_mus": [[m.real, m.imag] for m in mus],
        "floquet_abs": [float(a) for a in np.abs(mus)],
        "neutral_multiplier_dev": float(np.min(np.abs(np.abs(mus) - 1.0))),
        "reference": "examples/cylinder/newton/Re180_periodic_orbit/1cyl.usr:24 (T0=5.158)",
    }
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)


if __name__ == "__main__":
    main()
