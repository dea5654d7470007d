"""Resolvent response sweep over forcing frequency.

Reference case: examples/cylinder/resolvent + back_fstep/gramian (SURVEY
3.4): for each omega, apply the time-domain resolvent (i omega - A)^-1 to a
localized actuator force field and record the response amplitude at a sensor
— the reference's amplitude.dat / resolvent.txt frequency sweeps.

Usage: python examples/resolvent_sweep.py [--omegas 0.6,0.8,1.0]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--omegas", default="0.6,0.8,1.0,1.2")
    ap.add_argument("--re", type=float, default=60.0)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--outdir", default=None)
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

    from neklab_tpu.linops.resolvent import Resolvent
    from neklab_tpu.mesh.box import box_mesh
    from neklab_tpu.models.linearized import LinConfig
    from neklab_tpu.models.navier_stokes import FlowConfig
    from neklab_tpu.ops import sem

    dtype = jnp.float64 if args.f64 else jnp.float32
    tols = dict(vtol=1e-12, ptol=1e-12) if args.f64 else dict(vtol=1e-7, ptol=1e-7)

    # plane channel with a Gaussian actuator/sensor pair (the reference's
    # make_actuator/make_sensor, examples/cylinder/resolvent/1cyl.usr:1-63)
    mesh = box_mesh(
        (8, 6), ((0, 2 * np.pi), (-1, 1)),
        {"x-": "P", "x+": "P", "y-": "W", "y+": "W"}, order=6, dtype=dtype,
    )
    cfg = LinConfig(flow=FlowConfig(viscosity=1 / args.re, dt=1.0, **tols))
    y = mesh.x[1]
    U = jnp.stack([1 - y**2, 0 * y])

    xa, ya, s2 = 1.0, -0.4, 0.05  # actuator
    xs, ys = 4.0, 0.4  # sensor
    gauss = lambda x0, y0: jnp.exp(-((mesh.x[0] - x0) ** 2 + (mesh.x[1] - y0) ** 2) / (2 * s2))
    f_re = mesh.vmask * jnp.stack([0 * y, gauss(xa, ya)])
    f_im = jnp.zeros_like(f_re)
    sensor = gauss(xs, ys)
    snorm = float(sem.mass_dot(mesh, sensor, sensor))

    zero_t = jnp.zeros((0,) + mesh.bm1.shape, dtype)
    f = {"re": {"u": f_re, "theta": zero_t}, "im": {"u": f_im, "theta": zero_t}}
    rows = []
    for omega in [float(w) for w in args.omegas.split(",")]:
        R = Resolvent(mesh, cfg, U, omega=omega, dt=0.02, gmres_rtol=1e-6)
        t0 = time.time()
        x = R.matvec(f)
        u_re, u_im = x["re"]["u"], x["im"]["u"]
        # sensor amplitude |<s, u>| of the complex response
        a_re = float(sem.mass_dot(mesh, sensor, u_re[1]))
        a_im = float(sem.mass_dot(mesh, sensor, u_im[1]))
        amp = float(np.hypot(a_re, a_im) / np.sqrt(snorm))
        energy = float(
            np.sqrt(sem.mass_dot(mesh, u_re, u_re) + sem.mass_dot(mesh, u_im, u_im))
        )
        rows.append({"omega": omega, "amplitude": amp, "energy": energy,
                     "seconds": time.time() - t0})
        print(f"omega={omega:.3f}: sensor amplitude {amp:.4e}, "
              f"response energy {energy:.4e}", flush=True)

    out = {"case": "resolvent_sweep", "re": args.re, "rows": rows}
    print(json.dumps(out), flush=True)
    if args.outdir:
        os.makedirs(args.outdir, exist_ok=True)
        with open(os.path.join(args.outdir, "resolvent.txt"), "w") as f:
            for r in rows:
                f.write(f"{r['omega']:.6f} {r['amplitude']:.10e} {r['energy']:.10e}\n")


if __name__ == "__main__":
    main()
