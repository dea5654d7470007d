"""Benchmark: linearized Navier-Stokes propagator throughput on one GPU.

    python bench.py

Runs every case in this one process on one card and prints one JSON line per
case, then a summary line. Each line names the device (platform, device_kind,
device count) and the card's name and power limit as nvidia-smi reports them.
There is no fallback: without a GPU, or on a device this file has no peak
rates for, the run fails.

The propagator `exp(tau A)` (models/linearized.propagate) is the hot path of
every stability analysis: each Arnoldi matvec is O(10^2-10^3) such steps.

Measurement protocol: the state is B-normalized before every timed call, as
an Arnoldi vector is. The inner solves stop at ABSOLUTE tolerances, so a
state left to decay sinks below them, every solve exits at ~0 iterations and
the time collapses to kernel overhead. Both numbers are reported:
`s_per_step` (sustained, the headline) and `s_per_step_floor` (the same
program on a ~1e-8-scaled state: the per-step cost at ~0 solver iterations).

Cases:
  * box2d: 2-D periodic channel, 64x16 elements, order 7, 131k velocity DOF;
  * box3d: 3-D duct, 12^3 elements, order 5, 1.12M velocity DOF.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np

# Published peak rates of one card, dense, without sparsity (NVIDIA H100
# data sheet, SXM part, at its full 700 W power limit). Keyed by
# jax.devices()[0].device_kind; a device missing here is an error.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "fp64_flops": 34e12,
        "fp64_tensor_flops": 67e12,
        "fp32_flops": 67e12,
        "tf32_tensor_flops": 495e12,
        "bf16_tensor_flops": 989e12,
    },
}


def peaks_for(device_kind: str) -> dict:
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peak rates for device {device_kind!r}; add them to "
            "bench.PEAKS with their source") from None


def require_gpu():
    """The first device, which must be a GPU: measurements never fall back."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {dev.platform!r} ({dev.device_kind}); "
            "this path measures the GPU only")
    return dev


def card_name_and_power_limit() -> str:
    """`name, power.limit` of the cards, from nvidia-smi (a child that does
    not import JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def device_record() -> dict:
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def _time(fn, reps):
    import jax

    jax.block_until_ready(fn())  # compile + warm
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def sustained_and_floor(mesh, propagate_fn, u0, reps=3):
    """(seconds per call sustained, seconds per call floor): the sustained
    call sees a B-normalized state every time (an Arnoldi vector's scale),
    the floor call the same state scaled by 1e-8 (every inner solve
    trivially converged)."""
    import jax
    import jax.numpy as jnp

    from neklab_tpu.ops import sem

    @jax.jit
    def bnormalize(u):
        return u / jnp.sqrt(sem.mass_dot(mesh, u, u))

    state = [bnormalize(u0)]

    def run_norm():
        out = propagate_fn(state[0])
        state[0] = bnormalize(out)
        return out

    tiny = [1e-8 * state[0]]

    def run_floor():
        out = propagate_fn(tiny[0])
        tiny[0] = 1e-8 * bnormalize(out)
        return out

    return _time(run_norm, reps), _time(run_floor, reps)


def _case(mesh, base_u, tol, vmaxit, pmaxit, seed):
    """(mesh, cfg, base_u, u0, pc, vdiag) for the linearized step about base_u."""
    import jax

    from neklab_tpu.models.linearized import LinConfig
    from neklab_tpu.models.navier_stokes import _BDF, FlowConfig, helmholtz_diag
    from neklab_tpu.models.precond import build_e_preconditioner

    cfg = LinConfig(flow=FlowConfig(
        viscosity=1e-3, dt=2e-3, vtol=tol, ptol=tol, vmaxit=vmaxit, pmaxit=pmaxit))
    g0 = _BDF[3][0]
    u0 = mesh.vmask * jax.random.normal(
        jax.random.PRNGKey(seed), (mesh.ndim,) + mesh.bm1.shape, mesh.bm1.dtype)
    pc = build_e_preconditioner(mesh, cfg.flow.dt / g0)
    vdiag = helmholtz_diag(mesh, cfg.flow.viscosity, g0 / cfg.flow.dt, mesh.vmask)
    return mesh, cfg, base_u, u0, pc, vdiag


def channel_case(nels=(64, 16), order=7, dtype=None, tol=1e-5):
    """2-D periodic channel about U = 1 - y^2."""
    import jax.numpy as jnp

    from neklab_tpu.mesh.box import box_mesh

    mesh = box_mesh(
        nels, ((0.0, 2 * np.pi), (-1.0, 1.0)),
        {"x-": "P", "x+": "P", "y-": "W", "y+": "W"}, order=order,
        dtype=dtype or jnp.float32,
    )
    y = mesh.x[1]
    return _case(mesh, jnp.stack([1 - y**2, 0 * y]), tol, 50, 120, seed=0)


def duct_mesh(nels=(12, 12, 12), order=5, dtype=None):
    """3-D duct [0, 4] x [-1, 1]^2, periodic in x, walls elsewhere."""
    import jax.numpy as jnp

    from neklab_tpu.mesh.box import box_mesh

    return box_mesh(
        nels, ((0.0, 4.0), (-1.0, 1.0), (-1.0, 1.0)),
        {"x-": "P", "x+": "P", "y-": "W", "y+": "W", "z-": "W", "z+": "W"},
        order=order, dtype=dtype or jnp.float32,
    )


def duct_case(nels=(12, 12, 12), order=5, dtype=None, tol=1e-5):
    """3-D duct about U = (1 - y^2)(1 - z^2)."""
    import jax.numpy as jnp

    mesh = duct_mesh(nels, order, dtype)
    y, z = mesh.x[1], mesh.x[2]
    base_u = jnp.stack([(1 - y**2) * (1 - z**2), 0 * y, 0 * y])
    return _case(mesh, base_u, tol, 60, 150, seed=2)


def bench_case(case, nsteps, reps):
    import jax.numpy as jnp

    from neklab_tpu.models.linearized import propagate

    mesh, cfg, base_u, u0, pc, vdiag = case
    th = jnp.zeros((0,) + mesh.bm1.shape, mesh.bm1.dtype)

    def prop(u):
        return propagate(mesh, cfg, base_u, th, u, th, nsteps, pc_e=pc, vdiag=vdiag)[0]

    dof = mesh.ndim * mesh.nel * mesh.npts
    dt, dt_floor = sustained_and_floor(mesh, prop, u0, reps=reps)
    return {"nel": mesh.nel, "order": mesh.basis.n - 1, "dof": dof,
            "dtype": str(mesh.bm1.dtype), "steps_per_call": nsteps,
            "s_per_step": dt / nsteps, "dof_steps_per_s": dof * nsteps / dt,
            "s_per_step_floor": dt_floor / nsteps}


def main():
    from neklab_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = require_gpu()
    header = {"device": device_record(), "card": card_name_and_power_limit(),
              "peaks": peaks_for(dev.device_kind)}
    t0 = time.perf_counter()
    results = {}
    for name, build, nsteps, reps in (("box2d", channel_case, 100, 3),
                                      ("box3d", duct_case, 20, 2)):
        t_case = time.perf_counter()
        results[name] = bench_case(build(), nsteps, reps)
        results[name]["seconds"] = time.perf_counter() - t_case
        print(json.dumps({"case": name, **results[name], **header}), flush=True)
    print(json.dumps({
        "metric": "linearized_propagator_s_per_step",
        "value": results["box2d"]["s_per_step"], "unit": "s/step",
        "cases": results, "total_seconds": time.perf_counter() - t0, **header,
    }))


if __name__ == "__main__":
    main()
