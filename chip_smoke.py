"""Smoke run of the stability-analysis path on one GPU.

    python chip_smoke.py               # phases 0-5 on one card
    python chip_smoke.py --four-cards  # only the sharded legs, on four cards

Phases (one process; it is the only one using the card):
  0. device: a GPU or stop; the card's name and power limit; the compile cache.
  1. channel stability at the upstream settings (plane Poiseuille, Re=7500,
     alpha=1, kdim=128, nev=20, f32) against the Orr-Sommerfeld oracle;
  2. cylinder wake at Re=50, full pipeline (DNS spin-up, Newton-Krylov base
     flow, Krylov-Schur on exp(tau A)), coarse preset;
  3. a 1.12M-DOF 3-D duct: forward propagator and its exact adjoint, the
     adjoint identity, and the sustained and floor time per step;
  4. the 2-D channel case in f32 against f64 on the same card;
  5. the XLA-compiled Helmholtz apply, timed at the shapes of phases 2 and 3.

Each phase prints one JSON line: wall seconds, compile seconds (tracing,
lowering and XLA compilation or cache retrieval, summed from JAX's
monitoring events: set-up, reported apart from the work), the device's peak
bytes in use so far, and its checks, each with its limit and the reason for
that limit. The last line, printed only when every check passed, is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a GPU the run stops at phase 0 with a non-zero exit.

--four-cards runs __graft_entry__.dryrun_multichip(4) and nothing else: the
nonlinear step on a sharded box, and the linearized, exact-adjoint and
chunked propagators on an unstructured mesh, sharded over four cards against
unsharded on one, in f64.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import numpy as np

import bench
import __graft_entry__
from examples import cylinder_stability, poiseuille_stability

_COMPILE_EVENTS = (
    "/jax/core/compile/jaxpr_trace_duration",
    "/jax/core/compile/jaxpr_to_mlir_module_duration",
    "/jax/core/compile/backend_compile_duration",  # includes cache reads
)


class CompileClock:
    """Seconds JAX spent tracing, lowering, compiling or fetching compiled
    programs from the persistent cache since `start`."""

    def __init__(self):
        self.seconds = 0.0

    def start(self):
        import jax

        def listen(event, duration, **_):
            if event in _COMPILE_EVENTS:
                self.seconds += duration

        jax.monitoring.register_event_duration_secs_listener(listen)
        return self


def _check(name, value, limit, why):
    return {"name": name, "value": float(value), "limit": float(limit),
            "why": why, "ok": bool(np.isfinite(value) and abs(value) <= limit)}


def phase0_device():
    """The first device must be a GPU; the card's name and power limit as
    nvidia-smi gives them."""
    dev = bench.require_gpu()
    return {"device_kind": dev.device_kind, "card": bench.card_name_and_power_limit(),
            "checks": []}


def phase1_channel(preset="fine", re=7500.0, alpha=1.0, band=2e-4):
    rec = poiseuille_stability.run(preset, re=re, alpha=alpha)
    rec["checks"] = [_check(
        "leading eigenvalue - Orr-Sommerfeld oracle", rec["os_match_err"], band,
        "the 2e-4 band of tests/test_stability.py: spectral-element error at "
        "this resolution plus the eigensolver's 1e-6 residual tolerance")]
    return rec


def phase2_cylinder(preset="coarse", mu_band=8e-3, omega_band=0.05):
    rec = cylinder_stability.run(preset)
    rec["checks"] = [
        _check("|mu1| - 1.0156", rec["mu1_abs"] - 1.0156, mu_band,
               "the coarse preset's band in tests/test_integration.py: the "
               "coarse mesh is discretization-limited near |mu1| = 1.010"),
        _check("omega - 0.75", rec["omega"] - 0.75, omega_band,
               "shedding frequency band of tests/test_integration.py"),
    ]
    return rec


def phase3_adjoint(nels=(12, 12, 12), order=5, nsteps=20, tol=1e-6, band=1e-4,
                   reps=2):
    """Forward propagator and its exact adjoint (linear_transpose through
    custom_linear_solve) on the 3-D duct in f32."""
    import jax
    import jax.numpy as jnp

    from neklab_tpu.models.linearized import make_adjoint_propagator, propagate
    from neklab_tpu.ops import sem

    mesh, cfg, base_u, u0, pc, vdiag = bench.duct_case(nels, order, tol=tol)
    th = jnp.zeros((0,) + mesh.bm1.shape, mesh.bm1.dtype)

    def admissible(key):
        # the identity holds on the C0-continuous, BC-masked subspace the
        # operator acts on; B-normalized like an Arnoldi vector
        w = mesh.vmask * jax.random.normal(key, u0.shape, u0.dtype)
        w = mesh.vmask * sem.dsavg(mesh, w)
        return w / jnp.sqrt(sem.mass_dot(mesh, w, w))

    u, v = admissible(jax.random.PRNGKey(11)), admissible(jax.random.PRNGKey(12))
    mu = propagate(mesh, cfg, base_u, th, u, th, nsteps, pc_e=pc, vdiag=vdiag)[0]
    adj = make_adjoint_propagator(mesh, cfg, base_u, th, nsteps, pc_e=pc, vdiag=vdiag)
    mtv = adj(v, th)[0]
    lhs = float(sem.mass_dot(mesh, mu, v))
    rhs = float(sem.mass_dot(mesh, u, mtv))
    scale = float(jnp.sqrt(sem.mass_dot(mesh, mu, mu) * sem.mass_dot(mesh, v, v)))
    err = abs(lhs - rhs) / scale

    def prop(w):
        return propagate(mesh, cfg, base_u, th, w, th, nsteps, pc_e=pc, vdiag=vdiag)[0]

    t, t_floor = bench.sustained_and_floor(mesh, prop, u0, reps=reps)
    return {
        "nel": mesh.nel, "order": order, "dof": mesh.ndim * mesh.nel * mesh.npts,
        "dtype": str(mesh.bm1.dtype), "nsteps": nsteps, "inner_tol": tol,
        "lhs": lhs, "rhs": rhs,
        "s_per_step": t / nsteps, "s_per_step_floor": t_floor / nsteps,
        "state_protocol": "B-normalized before every call (sustained); "
                          "1e-8-scaled (floor)",
        "checks": [_check(
            "|<Mu,v>_B - <u,M*v>_B| / (|Mu|_B |v|_B)", err, band,
            "f32 level for inner tolerances near 1e-6: the transposed solves "
            "truncate like the forward ones, and f32 sums over 1e6 terms")],
    }


def phase4_precision(nels=(64, 16), order=7, nsteps=100, tol=1e-5, band=1e-4):
    """The same 100 steps from the same start in f32 and in f64 on one card;
    f64 is the reference."""
    import jax
    import jax.numpy as jnp

    from neklab_tpu.models.linearized import propagate

    def run(dtype, start=None):
        mesh, cfg, base_u, u0, pc, vdiag = bench.channel_case(nels, order, dtype, tol=tol)
        u0 = u0 if start is None else jnp.asarray(start, dtype)
        th = jnp.zeros((0,) + mesh.bm1.shape, dtype)
        out = propagate(mesh, cfg, base_u, th, u0, th, nsteps, pc_e=pc, vdiag=vdiag)[0]
        return np.asarray(u0), np.asarray(out)

    start, u32 = run(jnp.float32)
    with jax.enable_x64(True):
        _, u64 = run(jnp.float64, start)
    err = float(np.abs(u32 - u64).max() / np.abs(u64).max())
    return {
        "nel": int(np.prod(nels)), "order": order, "nsteps": nsteps, "inner_tol": tol,
        "dtype_32": str(u32.dtype), "dtype_64": str(u64.dtype),
        "checks": [_check(
            "max|u_f32 - u_f64| / max|u_f64|", err, band,
            f"ten times the inner solves' absolute residual tolerance "
            f"({tol:g}) on O(1) fields: two runs that each stop within it of "
            "the exact step differ by about that much, and the decaying "
            "dynamics does not amplify it; TF32 contractions (~5e-4 relative "
            "each, inside every CG iteration) would exceed it")],
    }


def _time_helmholtz(mesh, reps):
    """Seconds per XLA-compiled helmholtz_local apply: `reps` applies chained
    in one program, each scaled by the inverse of the operator's largest
    eigenvalue (power iteration) so the chain stays bounded."""
    import jax
    import jax.numpy as jnp

    from neklab_tpu.ops import sem

    h1, h2 = 0.02, 183.3  # viscosity and g0/dt of the cylinder case
    apply = jax.jit(lambda w: sem.helmholtz_local(mesh, w, h1, h2))
    w = jax.random.normal(jax.random.PRNGKey(7), mesh.bm1.shape, mesh.bm1.dtype)
    for _ in range(20):
        w = apply(w)
        lam = jnp.sqrt(jnp.sum(w * w))
        w = w / lam
    c = 1.0 / float(lam)

    @jax.jit
    def chain(w):
        for _ in range(reps):
            w = c * sem.helmholtz_local(mesh, w, h1, h2)
        return w

    jax.block_until_ready(chain(w))
    t0 = time.perf_counter()
    out = jax.block_until_ready(chain(w))
    t = (time.perf_counter() - t0) / reps
    return t, bool(np.isfinite(np.asarray(out)).all())


def phase5_helmholtz(shapes=None, reps=50):
    """Time sem.helmholtz_local as XLA compiles it, at the cylinder shape of
    phase 2 and the duct shape of phase 3: the time any fused GPU kernel of
    it would have to beat."""
    import jax.numpy as jnp

    shapes = shapes or {
        "cylinder": cylinder_stability.PRESETS["coarse"][:4],
        "duct": ((12, 12, 12), 5),
    }
    meshes = {
        "cylinder": cylinder_stability.make_mesh(*shapes["cylinder"], jnp.float32),
        "duct": bench.duct_mesh(*shapes["duct"]),
    }
    rec, checks = {}, []
    for name, mesh in meshes.items():
        t, finite = _time_helmholtz(mesh, reps)
        rec[name] = {"field_shape": list(mesh.bm1.shape), "s_per_apply": t}
        checks.append(_check(f"{name}: non-finite output of the timed chain",
                             0.0 if finite else np.inf, 0.0,
                             "the chain is scaled to stay bounded"))
    rec["checks"] = checks
    return rec


def _run(name, fn, clock, dev, failures, **kwargs):
    c0, t0 = clock.seconds, time.perf_counter()
    try:
        rec = fn(**kwargs)
    except Exception:
        traceback.print_exc()
        rec = {"error": traceback.format_exc(limit=3).splitlines()[-1],
               "checks": [{"name": "exception", "ok": False}]}
    wall = time.perf_counter() - t0
    stats = dev.memory_stats() or {}
    rec = {"phase": name, "wall_seconds": wall, "compile_seconds": clock.seconds - c0,
           "peak_bytes_in_use": stats.get("peak_bytes_in_use"), **rec}
    print(json.dumps(rec), flush=True)
    failures.extend(f"{name}: {c['name']}" for c in rec["checks"] if not c["ok"])
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded legs of __graft_entry__ on four cards")
    args = ap.parse_args(argv)

    import jax

    from neklab_tpu.utils.compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    clock = CompileClock().start()
    t0 = time.perf_counter()
    try:
        rec0 = phase0_device()
    except RuntimeError as e:
        print(f"phase 0 failed: {e}", file=sys.stderr)
        return 2
    dev = jax.devices()[0]
    print(rec0["card"], flush=True)
    print(json.dumps({"phase": "0_device", "compile_cache_dir": cache_dir, **rec0}),
          flush=True)

    failures = []
    if args.four_cards:
        if len(jax.devices()) < 4:
            print(f"--four-cards needs 4 GPUs, found {len(jax.devices())}", file=sys.stderr)
            return 2

        def sharded():
            errs = __graft_entry__.dryrun_multichip(4)
            return {"errors": errs, "checks": [
                _check(f"sharded - unsharded ({k})", v, 1e-7,
                       "f64 inner solves to 1e-11/1e-10; sharding only "
                       "reorders reductions") for k, v in errs.items()]}

        _run("four_cards", sharded, clock, dev, failures)
    else:
        for name, fn in (("1_channel", phase1_channel), ("2_cylinder", phase2_cylinder),
                         ("3_adjoint", phase3_adjoint), ("4_precision", phase4_precision),
                         ("5_helmholtz", phase5_helmholtz)):
            _run(name, fn, clock, dev, failures)
    print(json.dumps({"total_seconds": time.perf_counter() - t0,
                      "compile_seconds": clock.seconds, "failures": failures}),
          flush=True)
    if failures:
        return 1
    print(json.dumps({"ok": True, "device": bench.device_record()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
