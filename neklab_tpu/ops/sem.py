"""Element-local and assembled SEM operators.

All operators act on fields shaped [nel, (t,)s, r] (scalars) or
[ndim, nel, (t,)s, r] (vector fields). "Weak" operators return residual
vectors already weighted by quadrature (test-function form, unassembled);
assembly across element boundaries is the separate `dssum`.

Everything here is linear in the field arguments given a fixed mesh, and
written only with gather/scatter-add/einsum so the whole stack is exactly
`jax.linear_transpose`-able — that is how the framework obtains discrete
adjoints (vs. the reference's hand-coded `convop_adj`,
/root/reference/src/linops/neklab_linops.f90:287-302).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..mesh.core import SemMesh
from . import tensor as _tensor
from .tensor import apply_r, apply_s, apply_t, grad_rst, grad_rst_t, interp_nd, interp_nd_t


def tensor_precision():
    return _tensor.PRECISION

__all__ = [
    "dssum",
    "dsavg",
    "grad",
    "grad_d",
    "stiffness_local",
    "helmholtz_local",
    "wgradp_t",
    "convect_weak",
    "convect_volume_weak",
    "mass_dot",
]


# ---------------------------------------------------------------------------
# direct-stiffness summation (gather-scatter)
# ---------------------------------------------------------------------------


def _struct_info(mesh: SemMesh):
    """Parse structured-grid metadata: element-grid shape (leading-first,
    matching the C-ordered flat element axis) and per-direction periodicity.
    2-D: (el_s, el_r), (per_s, per_r); 3-D: (el_t, el_s, el_r), (...)."""
    for k, v in mesh.bc:
        if k == "__struct__":
            a = [int(t) for t in v.split(",")]
            nd = len(a) // 2
            return tuple(a[:nd]), tuple(bool(t) for t in a[nd:])
    return None


def dssum(mesh: SemMesh, f: jnp.ndarray) -> jnp.ndarray:
    """Direct-stiffness sum: add all element-local copies of each shared DOF
    and write the sum back into every copy. Works on [..., pts..., nel]
    fields with arbitrary leading axes.

    Equivalent of Nek5000 `dssum`/`opdssum` via gslib (SURVEY section 2.2).
    Structured (box/annulus) meshes use the scatter-free factorized face
    exchange — pure rolls/slices instead of a gather/scatter into the
    global-DOF array (chosen before the port to the H100; not measured
    there); unstructured meshes fall back to the general scatter path.
    """
    if f.size == 0:  # zero-size leading axes (e.g. nscal=0 scalar stacks)
        return f
    info = _struct_info(mesh)
    if info is not None:
        return _dssum_structured(f, mesh.basis.n, *info)
    if mesh.fp_pidx is not None and mesh.ndim == 2:
        return _dssum_facepair(mesh, f)
    lead = f.shape[: f.ndim - mesh.gidx.ndim]
    flat = f.reshape(lead + (-1,))
    gsum = jnp.zeros(lead + (mesh.nglob,), f.dtype).at[..., mesh.gidx.reshape(-1)].add(flat)
    out = gsum[..., mesh.gidx.reshape(-1)]
    return out.reshape(f.shape)


def _dssum_facepair(mesh: SemMesh, f: jnp.ndarray) -> jnp.ndarray:
    """Direct-stiffness sum on an UNSTRUCTURED conforming 2-D mesh via the
    precomputed face-pair schedule (mesh/core.py:_facepair_schedule).

    Interior-edge DOFs have exactly two copies: add the partner face value —
    ONE element-axis gather over the stacked [n, 4*nel] face strips; the
    orientation flip is applied AFTER the gather (reversing the gathered run
    along my own n axis lands on the partner's n-1-i value). Vertex DOFs
    (arbitrary multiplicity) are summed by sibling-copy gathers over the
    [4*nel] corner vector (zero-padded), so the whole exchange is
    gather/slice arithmetic with no scatters. Gathers touch only the face
    strips instead of the whole field, unlike the global scatter-add
    fallback below (chosen before the port to the H100; not measured
    there).
    """
    import numpy as np  # static constants only

    n = mesh.basis.n
    nel = mesh.nel
    lead = f.shape[:-3]
    G = jnp.stack(
        [f[..., 0, :, :], f[..., n - 1, :, :], f[..., :, 0, :], f[..., :, n - 1, :]],
        axis=-2,
    )  # [lead, n, 4, nel]
    Gf = G.reshape(lead + (n, 4 * nel))
    if mesh.fp_roll_mask is not None and len(mesh.fp_roll_off):
        # roll-decomposed permutation (mesh/core.py:_roll_plan): a handful of
        # masked shifted reads that XLA fuses, instead of an arbitrary gather
        # (chosen before the port to the H100; not measured there). The
        # small remainder is a column scatter.
        P = None
        for k, d in enumerate(mesh.fp_roll_off):
            term = mesh.fp_roll_mask[k] * jnp.roll(Gf, -d, axis=-1)
            P = term if P is None else P + term
        if mesh.fp_rem_dst.shape[0]:
            # rem_dst comes from np.nonzero in mesh/core.py:_roll_plan, so it
            # is unique and sorted; declaring that keeps the scatter
            # `jax.linear_transpose`-able (scatter transpose is only defined
            # for unique indices), which the exact discrete adjoint relies on.
            P = P.at[..., mesh.fp_rem_dst].set(
                Gf[..., mesh.fp_rem_src],
                unique_indices=True,
                indices_are_sorted=True,
            )
    else:
        P = Gf[..., mesh.fp_pidx]
    em = np.ones(n)
    em[0] = em[-1] = 0.0  # endpoints are vertex DOFs: handled below
    C = jnp.where(mesh.fp_flip, jnp.flip(P, axis=-2), P)
    C = C * (mesh.fp_mask * jnp.asarray(em, f.dtype)[:, None])
    C = C.reshape(lead + (n, 4, nel))

    V = jnp.stack(
        [f[..., 0, 0, :], f[..., 0, n - 1, :], f[..., n - 1, 0, :], f[..., n - 1, n - 1, :]],
        axis=-2,
    ).reshape(lead + (4 * nel,))
    if mesh.vs_roll_mask is not None and (len(mesh.vs_roll_off) or mesh.vs_rem_dst.shape[0]):
        Vn = V
        for k, d in enumerate(mesh.vs_roll_off):
            Vn = Vn + mesh.vs_roll_mask[k] * jnp.roll(V, -d, axis=-1)
        if mesh.vs_rem_dst.shape[0]:
            Vn = Vn.at[..., mesh.vs_rem_dst].add(V[..., mesh.vs_rem_src])
    else:
        Vext = jnp.concatenate([V, jnp.zeros(lead + (1,), f.dtype)], axis=-1)
        Vn = V
        for j in range(mesh.fp_vsib.shape[0]):
            Vn = Vn + Vext[..., mesh.fp_vsib[j]]
    Vn = Vn.reshape(lead + (4, nel))

    # assemble by concatenation (3 big copies) instead of slice updates
    # (8 dynamic-update-slice kernels): corrected boundary rows carry the
    # edge additions at interior positions and the vertex sums at endpoints.
    mid_s0 = f[..., 0, 1 : n - 1, :] + C[..., 1 : n - 1, 0, :]
    mid_s1 = f[..., n - 1, 1 : n - 1, :] + C[..., 1 : n - 1, 1, :]
    row_s0 = jnp.concatenate(
        [Vn[..., 0, :][..., None, :], mid_s0, Vn[..., 1, :][..., None, :]], axis=-2
    )
    row_s1 = jnp.concatenate(
        [Vn[..., 2, :][..., None, :], mid_s1, Vn[..., 3, :][..., None, :]], axis=-2
    )
    col_r0 = f[..., 1 : n - 1, 0, :] + C[..., 1 : n - 1, 2, :]
    col_r1 = f[..., 1 : n - 1, n - 1, :] + C[..., 1 : n - 1, 3, :]
    mid = jnp.concatenate(
        [col_r0[..., :, None, :], f[..., 1 : n - 1, 1 : n - 1, :], col_r1[..., :, None, :]],
        axis=-2,
    )
    return jnp.concatenate(
        [row_s0[..., None, :, :], mid, row_s1[..., None, :, :]], axis=-3
    )


def _dssum_structured(f, n, els, periodic):
    """Factorized direct-stiffness sum on a structured element grid (2-D or
    3-D): per-direction face exchanges applied sequentially — rolls and
    slices only, which XLA fuses and (under sharding) lowers to neighbor
    collective-permutes. Edges/corners are handled by the factorization
    (dimension splitting is exact on tensor-product topologies).

    f: [..., (t,) s, r, nel] with nel C-ordered over els (leading dim first,
    r-direction fastest)."""
    ndim = len(els)
    lead = f.shape[: -ndim - 1]
    g = f.reshape(lead + (n,) * ndim + tuple(els))
    N = len(lead) + 2 * ndim

    def ix(ax, sl, extra=None):
        out = [slice(None)] * N
        out[ax % N] = sl
        if extra is not None:
            out[extra[0] % N] = extra[1]
        return tuple(out)

    for d in range(ndim):  # d = 0: r (fastest), 1: s, 2: t
        na = -(ndim + 1 + d)  # node axis for this direction
        ea = -(1 + d)  # element axis
        size = els[ndim - 1 - d]
        per = periodic[ndim - 1 - d]
        hi = g[ix(na, -1)]
        lo = g[ix(na, 0)]
        if per:
            s = hi + jnp.roll(lo, -1, axis=ea)
            g = g.at[ix(na, -1)].set(s).at[ix(na, 0)].set(jnp.roll(s, 1, axis=ea))
        elif size > 1:
            nh = hi.ndim
            s = hi[ix(ea, slice(None, -1))[-nh:]] + lo[ix(ea, slice(1, None))[-nh:]]
            g = g.at[ix(na, -1, (ea, slice(None, -1)))].set(s)
            g = g.at[ix(na, 0, (ea, slice(1, None)))].set(s)
    return g.reshape(f.shape)


def dsavg(mesh: SemMesh, f: jnp.ndarray) -> jnp.ndarray:
    """Average shared DOFs (dssum weighted by 1/multiplicity)."""
    return dssum(mesh, f) * mesh.vmult


def gather_global(mesh: SemMesh, fhat: jnp.ndarray) -> jnp.ndarray:
    """Q: global unique-DOF vector [..., nglob] -> local copies [..., nel, pts].

    The implicit solvers run their CG in the global representation, where the
    assembled operator Q^T H Q is Euclidean-symmetric (the local-copies form
    mask*dssum(H_local .) is NOT — dssum and H do not commute), which both CG
    and custom_linear_solve's symmetric transpose rule require.
    """
    out = fhat[..., mesh.gidx.reshape(-1)]
    return out.reshape(fhat.shape[:-1] + mesh.gidx.shape)


def scatter_global(mesh: SemMesh, f: jnp.ndarray) -> jnp.ndarray:
    """Q^T: local copies [..., pts..., nel] -> global sums [..., nglob].

    Structured meshes: factorized-face dssum (no scatter) + a first-copy
    gather; unstructured: scatter-add into the global array."""
    if f.size == 0:
        return f.reshape(f.shape[: f.ndim - mesh.gidx.ndim] + (mesh.nglob,))
    lead = f.shape[: f.ndim - mesh.gidx.ndim]
    info = _struct_info(mesh)
    if info is not None:
        summed = _dssum_structured(f, mesh.basis.n, *info)
        return summed.reshape(lead + (-1,))[..., mesh.gfirst]
    flat = f.reshape(lead + (-1,))
    return jnp.zeros(lead + (mesh.nglob,), f.dtype).at[..., mesh.gidx.reshape(-1)].add(flat)


# ---------------------------------------------------------------------------
# differential operators
# ---------------------------------------------------------------------------


def grad(mesh: SemMesh, u: jnp.ndarray) -> jnp.ndarray:
    """Pointwise physical gradient of scalar field u -> [ndim, nel, ...].

    du/dx_j = sum_a rx[a, j] * du/dr_a. The metric contraction is unrolled
    (scalar-indexed products) rather than an einsum over a freshly stacked
    axis: stacked-operand einsums blocked XLA's elementwise fusion on the
    earlier accelerator (not measured on the H100).
    """
    durst = grad_rst(u, _d(mesh), mesh.ndim)
    return jnp.stack(
        [sum(mesh.rx[a, j] * durst[a] for a in range(mesh.ndim)) for j in range(mesh.ndim)]
    )


def _d(mesh: SemMesh):
    return jnp.asarray(mesh.basis.d, dtype=mesh.bm1.dtype)


def stiffness_local(mesh: SemMesh, u: jnp.ndarray) -> jnp.ndarray:
    """Unassembled weak Laplacian: out = sum_a D_a^T ( sum_b g[a,b] D_b u ).

    This is (grad v, grad u) elementwise — Nek's `axhelm` stiffness part.
    """
    d = _d(mesh)
    du = grad_rst(u, d, mesh.ndim)  # tuple over reference axes
    g = mesh.g
    nd = mesh.ndim
    # Unrolled metric contraction (NOT einsum over a stacked axis — see grad).
    flux = tuple(
        sum(g[a, b] * du[b] for b in range(nd)) for a in range(nd)
    )
    return grad_rst_t(flux, d, nd)


def helmholtz_local(mesh: SemMesh, u: jnp.ndarray, h1, h2) -> jnp.ndarray:
    """Unassembled Helmholtz operator h1 * A u + h2 * B u (Nek `axhelm`)."""
    return h1 * stiffness_local(mesh, u) + h2 * mesh.bm1 * u


def wgradp_t(mesh: SemMesh, v: jnp.ndarray) -> jnp.ndarray:
    """Weak 'transpose gradient' of a vector field: rhs_i = (grad phi_i, v).

    rhs = sum_a D_a^T ( w*jac * sum_k rx[a,k] v_k ). Used as the RHS builder
    of the pressure Poisson solve: (grad phi, grad p) = (grad phi, u_hat)/dt.
    v: [ndim, nel, ...] -> scalar test residual [nel, ...].
    """
    d = _d(mesh)
    wjac = mesh.bm1  # w * jac
    nd = mesh.ndim
    flux = tuple(sum(mesh.rx[a, k] * v[k] for k in range(nd)) * wjac for a in range(nd))
    return grad_rst_t(flux, d, nd)


# ---------------------------------------------------------------------------
# dealiased convection
# ---------------------------------------------------------------------------


def grad_d(mesh: SemMesh, u: jnp.ndarray) -> jnp.ndarray:
    """Physical gradient of u evaluated on the dealias (Gauss) grid.

    Exact: du/dr is a polynomial representable on the coarse grid, so we
    differentiate on GLL, interpolate to Gauss, and combine with the exact
    fine-grid metric rxd.
    """
    d = _d(mesh)
    jd = jnp.asarray(mesh.basis.jd, dtype=u.dtype)
    durst_d = [interp_nd(jd, c, mesh.ndim) for c in grad_rst(u, d, mesh.ndim)]
    nd = mesh.ndim
    return jnp.stack(
        [sum(mesh.rxd[a, j] * durst_d[a] for a in range(nd)) for j in range(nd)]
    )


def convect_weak(mesh: SemMesh, u: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
    """Weak-form dealiased convection of scalar u by velocity c:

      out_i = (phi_i, c . grad u)  evaluated on the Gauss dealias grid.

    u: [nel, ...]; c: [ndim, nel, ...] (GLL grid). Returns mass-weighted
    residual on the GLL grid. Reference: Nek `convop` with dealiasing
    (lxd grid), used by the linearized kernels at
    /root/reference/src/linops/neklab_linops.f90:268-313.
    """
    jd = jnp.asarray(mesh.basis.jd, dtype=u.dtype)
    nd = mesh.ndim
    d = _d(mesh)
    durst_d = [interp_nd(jd, comp, nd) for comp in grad_rst(u, d, nd)]
    s = None
    for k in range(nd):
        gu_dk = sum(mesh.rxd[a, k] * durst_d[a] for a in range(nd))
        ck_d = interp_nd(jd, c[k], nd)
        s = ck_d * gu_dk if s is None else s + ck_d * gu_dk
    return interp_nd_t(jd, s * mesh.bmd, nd)


def convect_volume_weak(mesh: SemMesh, u: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
    """Vectorized `convect_weak` over the leading component axis of u."""
    return jnp.stack([convect_weak(mesh, ui, c) for ui in u])


def lin_convect_cache(mesh: SemMesh, base_u: jnp.ndarray, base_theta=None):
    """Precompute the FROZEN base-flow quantities of the linearized
    advection on the dealias grid: U_d[k] = I_d U_k, gradU_d[i, k] =
    (grad_d U_i)_k, and (if scalars ride along) gradTh_d[s, k].

    These are loop-invariant across the propagator's time steps (the base
    flow is frozen), so computing them once per propagate instead of twice
    per step removes ~half the convection work of the hot path.
    """
    jd = jnp.asarray(mesh.basis.jd, dtype=base_u.dtype)
    nd = mesh.ndim
    u_d = jnp.stack([interp_nd(jd, base_u[k], nd) for k in range(nd)])
    gradu_d = jnp.stack([grad_d(mesh, base_u[i]) for i in range(nd)])
    if base_theta is not None and base_theta.shape[0]:
        gradth_d = jnp.stack([grad_d(mesh, base_theta[s]) for s in range(base_theta.shape[0])])
    else:
        gradth_d = None
    return {"ud": u_d, "gradud": gradu_d, "gradthd": gradth_d}


def convect_lin_weak(mesh: SemMesh, u: jnp.ndarray, theta, cache):
    """Fused weak-form linearized advection about a frozen base (U, Theta):

        n_u[i] = (phi_i, U . grad u_i) + (phi_i, u . grad U_i)
        n_t[s] = (q,     U . grad th_s) + (q,     u . grad Th_s)

    with the base-flow dealias quantities from `lin_convect_cache`. Linear
    in (u, theta); exactly transposable. Equivalent to the pairwise
    convect_weak sums but with one combined quadrature +
    back-interpolation pass per output and no per-step base interpolation
    (reference kernels: /root/reference/src/linops/neklab_linops.f90:268-313).
    Returns (n_u, n_t); n_t is None when no scalars are present.
    """
    ud_base, gradud_base, gradthd_base = cache["ud"], cache["gradud"], cache["gradthd"]
    jd = jnp.asarray(mesh.basis.jd, dtype=u.dtype)
    d = _d(mesh)
    nd = mesh.ndim
    u_d = [interp_nd(jd, u[k], nd) for k in range(nd)]

    def fused(field, grad_base_row):
        """(phi, U . grad field) + (phi, u . grad<base row>), one pass."""
        durst_d = [interp_nd(jd, c, nd) for c in grad_rst(field, d, nd)]
        s = None
        for k in range(nd):
            g_k = sum(mesh.rxd[a, k] * durst_d[a] for a in range(nd))
            term = ud_base[k] * g_k + u_d[k] * grad_base_row[k]
            s = term if s is None else s + term
        return interp_nd_t(jd, s * mesh.bmd, nd)

    n_u = jnp.stack([fused(u[i], gradud_base[i]) for i in range(nd)])
    n_t = None
    if theta is not None and theta.shape[0]:
        n_t = jnp.stack(
            [fused(theta[s], gradthd_base[s]) for s in range(theta.shape[0])]
        )
    return n_u, n_t


# ---------------------------------------------------------------------------
# inner products
# ---------------------------------------------------------------------------


def mass_dot(mesh: SemMesh, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Mass-weighted global inner product sum(u * v * bm1) over all leading
    axes. For C0 (continuous) fields this equals the assembled L2 product —
    the reference's `glsc3(u, v, bm1)` (real_vectors.f90:208-233)."""
    return jnp.sum(u * v * mesh.bm1)
