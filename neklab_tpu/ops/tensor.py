"""Tensor-product contractions over element-local SEM fields.

Field convention (throughout the framework) — ELEMENT-LAST layout:
  2-D: f[..., s, r, nel]
  3-D: f[..., t, s, r, nel]

The element axis sits last so every per-element operation vectorizes across
elements, and a 1-D operator A[m, n] applied along a reference axis is a
small-M GEMM with a huge N (n * nel). This layout was chosen before the
port to the H100 and has not been measured there.
"""

from __future__ import annotations

import jax.numpy as jnp

# Contraction precision: "highest" guarantees fp32-exact matmuls (needed for
# the f64 oracle suite and for f32 Krylov work).
PRECISION = "highest"


def set_precision(p: str) -> None:
    # "default" lets an f32 contraction run in TF32 on the H100 (about three
    # decimal digits), which the inner solves' tolerances do not survive.
    global PRECISION
    PRECISION = p

__all__ = ["apply_r", "apply_s", "apply_t", "grad_rst", "grad_rst_t", "interp_nd", "interp_nd_t"]


def apply_r(a, u):
    """Contract the r axis (second-to-last): out[..., i, e] = sum_j a[i,j] u[..., j, e]."""
    return jnp.einsum("ij,...je->...ie", a, u, precision=PRECISION)


def apply_s(a, u):
    """Contract the s axis (third-to-last)."""
    return jnp.einsum("ij,...jre->...ire", a, u, precision=PRECISION)


def apply_t(a, u):
    """Contract the t axis (fourth-to-last, 3-D only)."""
    return jnp.einsum("ij,...jsre->...isre", a, u, precision=PRECISION)


_APPLY = (apply_r, apply_s, apply_t)


# ---------------------------------------------------------------------------
# 3-D: optionally Kronecker-folded contractions.
#
# A per-axis apply on a 3-D field [..., t, s, r, e] as a batched [n x n]
# matmul has M = K = n (~8), far below a matrix unit's tile. Folding the
# operator into I (x) a (x) I and flattening the point axes turns every
# apply into ONE [n^3 x n^3]-by-[n^3, e] matmul (M = K = 512 at order 7) —
# 8x the FLOPs for matrix-unit-sized shapes. Whether that trade wins is
# hardware dependent. Default off (the fused small-einsum path won on the
# earlier accelerator; not measured on the H100); flip with set_kron3d(True).
# ---------------------------------------------------------------------------

KRON3D = False


def set_kron3d(flag: bool) -> None:
    global KRON3D
    KRON3D = flag


def _kron_fold(a, left: int, right: int):
    """I_left (x) a (x) I_right as a dense [left*m*right, left*k*right]."""
    il = jnp.eye(left, dtype=a.dtype)
    ir = jnp.eye(right, dtype=a.dtype)
    m, k = a.shape
    big = jnp.einsum("pq,ij,uv->piuqjv", il, a, ir)
    return big.reshape(left * m * right, left * k * right)


def _apply_axis3(a, u, axis: int):
    """Apply a along one reference axis of a 3-D field (axis 0=r, 1=s, 2=t):
    folded matmul when KRON3D is set, fused small einsums otherwise."""
    if not KRON3D:
        return (apply_r, apply_s, apply_t)[axis](a, u)
    pt, ps, pr = u.shape[-4], u.shape[-3], u.shape[-2]
    e = u.shape[-1]
    lead = u.shape[:-4]
    m = a.shape[0]
    if axis == 0:
        left, right, out_pts = pt * ps, 1, (pt, ps, m)
    elif axis == 1:
        left, right, out_pts = pt, pr, (pt, m, pr)
    else:
        left, right, out_pts = 1, ps * pr, (m, ps, pr)
    A = _kron_fold(a, left, right)
    x = u.reshape(lead + (pt * ps * pr, e))
    out = jnp.einsum("IJ,...Je->...Ie", A, x, precision=PRECISION)
    return out.reshape(lead + out_pts + (e,))


def grad_rst(u, d, ndim: int):
    """Reference-space gradient: tuple (u_r, u_s[, u_t]) via the derivative
    matrix d. Axis ordering of the result tuple is (r, s, t)."""
    if ndim == 2:
        return apply_r(d, u), apply_s(d, u)
    return _apply_axis3(d, u, 0), _apply_axis3(d, u, 1), _apply_axis3(d, u, 2)


def grad_rst_t(u, d, ndim: int):
    """Transpose-gradient accumulation: given fluxes (f_r, f_s[, f_t]) returns
    sum_k A_k^T f_k where A_k applies d along axis k. Used by the weak
    Laplacian: out = D_r^T f_r + D_s^T f_s (+ D_t^T f_t)."""
    dt = d.T
    if ndim == 2:
        fr, fs = u
        return apply_r(dt, fr) + apply_s(dt, fs)
    fr, fs, ft = u
    return _apply_axis3(dt, fr, 0) + _apply_axis3(dt, fs, 1) + _apply_axis3(dt, ft, 2)


def interp_nd(j, u, ndim: int):
    """Apply interpolation matrix j along every reference axis (grid change)."""
    if ndim == 2:
        return apply_s(j, apply_r(j, u))
    out = _apply_axis3(j, u, 0)
    out = _apply_axis3(j, out, 1)
    return _apply_axis3(j, out, 2)


def interp_nd_t(j, u, ndim: int):
    """Transpose interpolation along every axis (fine -> coarse projection)."""
    return interp_nd(j.T, u, ndim)
