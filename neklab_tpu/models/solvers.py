"""Matrix-free implicit solvers that live INSIDE jit.

`linear_solve` wraps preconditioned CG in `lax.custom_linear_solve` with
symmetric=True, which gives the whole time step two crucial properties:

  * `jax.linear_transpose` of a step transposes the solve by re-solving with
    the same (symmetric) operator — this is how the framework gets exact
    discrete adjoints of the linearized propagator instead of hand-coding
    adjoint kernels like the reference (neklab_linops.f90:287-302);
  * `jax.jvp` differentiates through the solve via implicit differentiation —
    this is how UPO/Floquet Jacobian-vector products are obtained.

Reference parity: Nek5000's `hmholtz` CG for velocity/scalars and the E-solve
for pressure (tolerances param(22)/param(21), set through
/root/reference/src/neklab_nek_setup.f90:227-237).
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax


def _tree_dot(x, y):
    return sum(
        jnp.sum(a * b) for a, b in zip(jax.tree_util.tree_leaves(x), jax.tree_util.tree_leaves(y))
    )


def _guarded_div(a, b):
    """a / b with b floored at the smallest normal number of its dtype: a
    CG that has reached its floating-point floor (rz or p.Ap == 0) takes a
    zero step instead of producing 0/0. A literal such as 1e-300 would
    round to 0 in f32 and guard nothing."""
    return a / jnp.maximum(b, jnp.finfo(b.dtype).tiny)


def pcg(
    op: Callable,
    b,
    precond: Callable | None = None,
    x0=None,
    tol: float = 1e-8,
    maxiter: int = 500,
):
    """Preconditioned conjugate gradient, jit-compatible (lax.while_loop).

    Stops at ||r||_2 <= max(tol, tiny). `tol` is an absolute tolerance on the
    Euclidean residual of the assembled system, matching Nek's residual-based
    stopping (`param(22)` semantics).
    """
    if precond is None:
        precond = lambda r: r
    if x0 is None:
        x0 = jax.tree_util.tree_map(jnp.zeros_like, b)

    r0 = jax.tree_util.tree_map(jnp.subtract, b, op(x0))
    z0 = precond(r0)
    rz0 = _tree_dot(r0, z0)
    rr0 = _tree_dot(r0, r0)

    def cond(state):
        _, _, _, _, rr, k = state
        return jnp.logical_and(rr > tol * tol, k < maxiter)

    def body(state):
        x, r, z, p, rr, k = state
        ap = op(p)
        rz = _tree_dot(r, z)
        alpha = _guarded_div(rz, _tree_dot(p, ap))
        x = jax.tree_util.tree_map(lambda xi, pi: xi + alpha * pi, x, p)
        r = jax.tree_util.tree_map(lambda ri, ai: ri - alpha * ai, r, ap)
        z = precond(r)
        rz_new = _tree_dot(r, z)
        beta = _guarded_div(rz_new, rz)
        p = jax.tree_util.tree_map(lambda zi, pi: zi + beta * pi, z, p)
        rr = _tree_dot(r, r)
        return (x, r, z, p, rr, k + 1)

    x, r, z, p, rr, k = lax.while_loop(cond, body, (x0, r0, z0, r0 if precond is None else z0, rr0, 0))
    return x


def pcg_info(
    op: Callable,
    b,
    precond: Callable | None = None,
    x0=None,
    tol: float = 1e-8,
    maxiter: int = 500,
):
    """pcg + diagnostics: (x, iterations, final ||r||^2). For solver-quality
    reporting (bench iteration counts) — custom_linear_solve cannot return
    auxiliary outputs, so production steps use `pcg`/`linear_solve` and the
    bench re-runs one representative solve through this entry."""
    if precond is None:
        precond = lambda r: r
    if x0 is None:
        x0 = jax.tree_util.tree_map(jnp.zeros_like, b)
    r0 = jax.tree_util.tree_map(jnp.subtract, b, op(x0))
    z0 = precond(r0)
    rr0 = _tree_dot(r0, r0)

    def cond(state):
        _, _, _, _, rr, k = state
        return jnp.logical_and(rr > tol * tol, k < maxiter)

    def body(state):
        x, r, z, p, rr, k = state
        ap = op(p)
        rz = _tree_dot(r, z)
        alpha = _guarded_div(rz, _tree_dot(p, ap))
        x = jax.tree_util.tree_map(lambda xi, pi: xi + alpha * pi, x, p)
        r = jax.tree_util.tree_map(lambda ri, ai: ri - alpha * ai, r, ap)
        z = precond(r)
        rz_new = _tree_dot(r, z)
        beta = _guarded_div(rz_new, rz)
        p = jax.tree_util.tree_map(lambda zi, pi: zi + beta * pi, z, p)
        return (x, r, z, p, _tree_dot(r, r), k + 1)

    x, r, z, p, rr, k = lax.while_loop(cond, body, (x0, r0, z0, z0, rr0, 0))
    return x, k, rr


def linear_solve(
    op: Callable,
    b,
    precond: Callable | None = None,
    tol: float = 1e-8,
    maxiter: int = 500,
    x0=None,
):
    """Symmetric linear solve via lax.custom_linear_solve(pcg).

    op must be symmetric positive (semi-)definite in the Euclidean inner
    product of its pytree representation.
    """

    def solve(matvec, rhs):
        return pcg(matvec, rhs, precond=precond, x0=x0, tol=tol, maxiter=maxiter)

    return lax.custom_linear_solve(op, b, solve=solve, symmetric=True)


def local_diagonal(op_local: Callable, shape, dtype, ndim_pts: int):
    """Exact diagonal of an element-local operator by probing.

    op_local maps [pts..., nel] -> [pts..., nel] elementwise per element
    (element-LAST layout). Probes every within-element basis function
    simultaneously across all elements (npts vmapped probes). The diagonal of
    the ASSEMBLED operator is then scatter_global(local diagonal).
    """
    pts_shape = shape[-ndim_pts - 1 : -1]
    nel = shape[-1]
    npts = 1
    for s in pts_shape:
        npts *= s

    eye = jnp.eye(npts, dtype=dtype)  # [npts, npts]

    def probe_node(e_flat):
        e = jnp.broadcast_to(e_flat.reshape(pts_shape + (1,)), shape)
        out = op_local(e)
        # value at the probed node, per element: sum over pts of out * e
        return (out * e).reshape(shape[: -ndim_pts - 1] + (npts, nel)).sum(-2)

    vals = jax.vmap(probe_node)(eye)  # [npts, lead..., nel]
    lead = shape[: -ndim_pts - 1]
    vals = jnp.moveaxis(vals, 0, -2)  # [lead..., npts, nel]
    return vals.reshape(lead + pts_shape + (nel,))
