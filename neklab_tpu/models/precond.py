"""Two-level additive Schwarz preconditioner for the pressure E operator.

The E ("consistent Poisson") solve is the stiff part of every time step —
the reference leans on Nek5000's semg/XXT two-level solver for it (C code;
SURVEY section 2.2 and hard part 1). The JAX equivalent, built once per
(mesh, dt/g0) on the host and applied inside jit as batched dense algebra:

  P^-1 r = sum_e R_e^T (E_ee)^-1 R_e r  +  R_c^T E_c^-1 R_c r

  * local level: exact element-diagonal blocks E_ee of E ((n-2)^d square,
    extracted by distance-2 graph-colored probing so neighboring elements
    never alias), inverted and applied as one batched matmul;
  * coarse level: piecewise-constant-per-element restriction; E_c = R E R^T
    assembled by distance-3 colored probing, factorized dense on the host
    and applied as a replicated [nel, nel] matmul — the XXT-coarse-solve
    analog (every chip solves the tiny coarse problem redundantly).

Cuts E-solve CG iteration counts by one to two orders of magnitude.

Scalability: the dense coarse inverse is O(nel^2) memory, so above
`coarse_max_dense` elements (default 4096) the coarse space automatically
switches from per-ELEMENT to per-AGGREGATE constants: elements are clustered
by recursive coordinate bisection into <= coarse_max_dense aggregates, the
aggregate operator E_a = R_a E R_a^T is probed with the same distance-3
coloring at aggregate granularity, and the apply becomes
segment-sum -> dense [nagg, nagg] matmul -> gather. Memory is then bounded by
coarse_max_dense^2 regardless of element count (the role of Nek's semg_xxt
hierarchy, SURVEY 2.2 hard part 1).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..mesh.core import SemMesh
from ..utils.pytrees import pytree_dataclass
from . import stokes


def element_adjacency(mesh: SemMesh) -> list[set[int]]:
    """Elements sharing any global DOF are adjacent (host-side, from gidx)."""
    gidx = np.asarray(mesh.gidx).reshape(-1, mesh.nel).T  # [nel, npts]
    dof_owners: dict[int, list[int]] = {}
    adj: list[set[int]] = [set() for _ in range(mesh.nel)]
    for e in range(mesh.nel):
        for g in np.unique(gidx[e]):
            dof_owners.setdefault(int(g), []).append(e)
    for owners in dof_owners.values():
        for a in owners:
            for b in owners:
                if a != b:
                    adj[a].add(b)
    return adj


def face_adjacency(mesh: SemMesh) -> list[set[int]]:
    """Elements sharing a FACE (>= 2 shared global DOFs in 2-D, >= 4 in 3-D)
    — excludes pure vertex/edge neighbors. Used for the overlapping-Schwarz
    patches, where face neighbors carry almost all of the coupling."""
    gidx = np.asarray(mesh.gidx).reshape(-1, mesh.nel).T
    dof_owners: dict[int, list[int]] = {}
    for e in range(mesh.nel):
        for g in np.unique(gidx[e]):
            dof_owners.setdefault(int(g), []).append(e)
    from collections import Counter

    pair_counts: Counter = Counter()
    for owners in dof_owners.values():
        for i, a in enumerate(owners):
            for b in owners[i + 1:]:
                pair_counts[(a, b) if a < b else (b, a)] += 1
    thresh = 2 if mesh.ndim == 2 else 4
    adj: list[set[int]] = [set() for _ in range(mesh.nel)]
    for (a, b), cnt in pair_counts.items():
        if cnt >= thresh:
            adj[a].add(b)
            adj[b].add(a)
    return adj


def greedy_coloring(adj: list[set[int]]) -> np.ndarray:
    n = len(adj)
    colors = -np.ones(n, dtype=np.int64)
    for v in range(n):
        used = {colors[u] for u in adj[v] if colors[u] >= 0}
        c = 0
        while c in used:
            c += 1
        colors[v] = c
    return colors


def _square_adjacency(adj: list[set[int]]) -> list[set[int]]:
    """Adjacency of the squared graph (distance <= 2)."""
    out = []
    for v, nb in enumerate(adj):
        s = set(nb)
        for u in nb:
            s |= adj[u]
        s.discard(v)
        out.append(s)
    return out


@pytree_dataclass
class ETwoLevel:
    """Additive two-level preconditioner data (a pytree of arrays).

    agg_of_el is None when the coarse space is per-element (nel small enough
    for the dense [nel, nel] inverse); otherwise it maps each element to its
    RCB aggregate and ec_inv is [nagg, nagg].

    eb_w/eb_nbr (optional) hold the EXACT neighbor-block (ELL) form of the
    E operator itself at dt_over_g0 = 1: E is block-sparse over elements
    (pressure is discontinuous; coupling reaches only adjacent elements
    through the velocity dssum), so

        (E p)|_e = s * sum_m eb_w[e, m] @ p|_{eb_nbr[e, m]},   s = dt/g0

    — ONE element-axis gather + ONE batched einsum. The matrix-free chain
    (grad_weak_t -> face-pair dssum -> div_weak) is ~40 XLA kernels; on the
    unstructured 2-D production meshes the solver is kernel-count-bound, so
    collapsing the per-CG-iteration operator to 2 kernels is the single
    biggest per-iteration win (round-3 profiling: e_op 518 us -> ~100 us).
    E(dt) = (dt/g0) * E(1) exactly, so the blocks are per-MESH, not per-dt
    (traced-dt UPO paths just scale the apply)."""

    blocks_inv: jnp.ndarray  # [nel, np2, np2]
    ec_inv: jnp.ndarray  # [nc, nc] dense inverse of the coarse operator
    agg_of_el: jnp.ndarray | None = None  # int32 [nel] or None
    # Q1 vertex coarse space (coarse="q1", 2-D): continuous-bilinear hats on
    # the element-corner vertices, E_c = P^T E P assembled EXACTLY from the
    # probed neighbor blocks. A Poisson-type coarse space with inter-element
    # continuity cuts E-solve iterations ~2-3x vs the piecewise-constant
    # coarse (the constant space cannot represent the smooth error at all).
    # When set, ec_inv is [nvert, nvert] and the coarse apply is
    # scatter(B4^T r) -> dense solve -> gather(B4 y).
    q1_vert: jnp.ndarray | None = None  # int32 [nel, 4] corner vertex ids
    q1_b4: jnp.ndarray | None = None  # [np2, 4] bilinear hat values at mesh-2 pts
    eb_w: jnp.ndarray | None = None  # [nel, K, np2, np2] exact E blocks (s=1)
    eb_nbr: jnp.ndarray | None = None  # int32 [nel, K] neighbor table
    # overlapping-Schwarz local level (local="oas"): face-neighbor patches,
    # sqrt-partition-of-unity weighted both sides (symmetric), patch solves
    # as one batched matmul. Cuts cold E iterations ~2.7x vs block-Jacobi on
    # the production cylinder mesh (342 -> 125 with the const coarse).
    oas_binv: jnp.ndarray | None = None  # [nel, P*np2, P*np2]
    oas_gin: jnp.ndarray | None = None  # int32 [nel, P] patch element ids
    oas_win: jnp.ndarray | None = None  # [nel, P] in-weights (0 on pads)
    oas_rev: jnp.ndarray | None = None  # int32 [nel, P] flat (el*P+slot) gather-back
    oas_wout: jnp.ndarray | None = None  # [nel, P] out-weights (0 on pads)

    def e_apply(self, p: jnp.ndarray, dt_over_g0) -> jnp.ndarray:
        """Exact E p via the neighbor-block form (requires eb_w).

        Layout-agnostic over the trailing field axes: works for 2-D
        ([.., n2, n2, nel]) and 3-D ([.., n2, n2, n2, nel]) element-last
        fields alike (any leading batch axes pass through)."""
        np2, nel = self.eb_w.shape[-1], self.eb_w.shape[0]
        # fold however many trailing axes make up the (np2, nel) field
        prod, k = 1, 0
        for s in reversed(p.shape):
            prod *= int(s)
            k += 1
            if prod == np2 * nel:
                break
        if prod != np2 * nel:
            raise ValueError(
                f"e_apply: trailing axes of {p.shape} do not fold to "
                f"({np2}, {nel})")
        pf = p.reshape(p.shape[: p.ndim - k] + (np2, nel))
        pg = pf[..., self.eb_nbr]  # [np2, nel, K]
        out = jnp.einsum("ekab,...bek->...ae", self.eb_w, pg,
                         precision="highest")
        return (dt_over_g0 * out).reshape(p.shape)

    def apply(self, r: jnp.ndarray) -> jnp.ndarray:
        # the stored matrices may be compressed to bf16 (preconditioner
        # accuracy is free; halves the dominant per-iteration HBM traffic);
        # all arithmetic promotes back to the field dtype
        dt = r.dtype
        nel = r.shape[-1]
        hi = "highest"  # f32 contractions must not round to TF32
        rf = r.reshape(-1, nel)  # [np2, nel] (element-last)
        if self.oas_binv is not None:
            np2 = rf.shape[0]
            P = self.oas_gin.shape[1]
            # gather patch residuals, weight, batched patch solve
            rp = rf.T[self.oas_gin] * self.oas_win[:, :, None]  # [nel, P, np2]
            sol = jnp.einsum(
                "eab,eb->ea", self.oas_binv, rp.reshape(nel, P * np2).astype(self.oas_binv.dtype),
                precision="highest",
            ).astype(dt).reshape(nel, P, np2)
            # gather back each element's own piece from every patch solve
            back = sol.reshape(nel * P, np2)[self.oas_rev]  # [nel, P, np2]
            local = (back * self.oas_wout[:, :, None]).sum(axis=1).T  # [np2, nel]
        else:
            local = jnp.einsum(
                "eab,be->ae", self.blocks_inv, rf.astype(self.blocks_inv.dtype),
                precision="highest",
            ).astype(dt)
        if self.q1_vert is not None:
            nvert = self.ec_inv.shape[0]
            # restrict: rc[v] = sum_{(e,c): vert(e,c)=v} (B4^T r_e)[c]
            rc_el = jnp.einsum("pe,pc->ec", rf, self.q1_b4.astype(dt), precision=hi)  # [nel, 4]
            rc = jax.ops.segment_sum(
                rc_el.reshape(-1), self.q1_vert.reshape(-1), num_segments=nvert
            )
            y = jnp.matmul(self.ec_inv, rc.astype(self.ec_inv.dtype), precision=hi).astype(dt)
            # prolong: p_e = B4 @ y[vert(e, :)]
            coarse = jnp.einsum("pc,ec->pe", self.q1_b4.astype(dt), y[self.q1_vert],
                                precision=hi)
            out = local + coarse
            return out.reshape(r.shape)
        rc = rf.sum(axis=0)
        if self.agg_of_el is not None:
            nagg = self.ec_inv.shape[0]
            rc = jax.ops.segment_sum(rc, self.agg_of_el, num_segments=nagg)
            coarse = jnp.matmul(
                self.ec_inv, rc.astype(self.ec_inv.dtype), precision=hi
            ).astype(dt)[self.agg_of_el]
        else:
            coarse = jnp.matmul(self.ec_inv, rc.astype(self.ec_inv.dtype),
                                precision=hi).astype(dt)
        out = local + coarse[None, :]
        return out.reshape(r.shape)


def _probe_e_blocks(mesh: SemMesh, adj, colors3):
    """Exact neighbor-block extraction of E at dt_over_g0 = 1 by distance-3
    colored probing (host-side numpy result).

    Returns (W [nel, K, np2, np2] f64, nbr int64 [nel, K], slot dict): for
    every element g, (E p)|_g = sum_m W[g, m] @ p|_{nbr[g, m]} exactly (pads
    carry zero blocks). W is symmetrized across partner blocks so the
    assembled operator is exactly symmetric (custom_linear_solve's
    symmetric-transpose rule requires it)."""
    np2 = int(np.prod(mesh.bm2.shape[:-1]))
    nel = mesh.nel
    dtype = mesh.bm2.dtype
    eop1 = jax.jit(lambda q: stokes.e_op(mesh, q, 1.0))

    nbrs = [sorted({e} | set(adj[e])) for e in range(nel)]
    K = max(len(v) for v in nbrs)
    nbr = np.zeros((nel, K), np.int64)
    for e, v in enumerate(nbrs):
        nbr[e, : len(v)] = v
        nbr[e, len(v):] = e  # pad with self (weight-zero blocks)
    slot = {}
    for e in range(nel):
        for m, f in enumerate(nbrs[e]):
            slot[(e, f)] = m

    W = np.zeros((nel, K, np2, np2))
    ncol3 = int(colors3.max()) + 1
    pats = jnp.eye(np2, dtype=dtype)
    # one device call per color, but results accumulate ON DEVICE and come
    # back in a SINGLE stacked host transfer instead of one round trip per
    # color
    cmask_all = jnp.asarray(
        (colors3[None, :] == np.arange(ncol3)[:, None]).astype(np.float64)
    ).astype(dtype)  # [ncol3, nel]

    @jax.jit
    def probe_color(mask_c):
        q = pats[:, :, None] * mask_c[None, None, :]  # [np2(j), np2, nel]
        return jax.vmap(eop1)(q.reshape((np2,) + mesh.bm2.shape)).reshape(np2, np2, nel)

    outs = jax.lax.map(probe_color, cmask_all)  # [ncol3, np2, np2, nel]
    outs = np.asarray(outs)  # ONE transfer
    for c in range(ncol3):
        out = outs[c]  # out[j, i, g] = E[(g, i), (f, j)] for the color-c source f near g
        for f in np.nonzero(colors3 == c)[0]:
            for g in nbrs[f]:  # supp(E e_f) is within f's neighborhood
                W[g, slot[(g, int(f))]] = out[:, :, g].T  # -> [i, j]
    # symmetrize partner blocks (probing is exact up to roundoff)
    for e in range(nel):
        for m, f in enumerate(nbrs[e]):
            if f >= e:
                mt = slot[(f, e)]
                avg = 0.5 * (W[e, m] + W[f, mt].T)
                W[e, m] = avg
                W[f, mt] = avg.T
    return W, nbr, slot, nbrs


_PC_FIELDS = ("blocks_inv", "ec_inv", "agg_of_el", "eb_w", "eb_nbr",
              "q1_vert", "q1_b4", "oas_binv", "oas_gin", "oas_win",
              "oas_rev", "oas_wout")


_PC_FORMAT = 2  # bump on any change to what the cached blob contains/means


def _pc_cache_path(mesh: SemMesh, dt_over_g0, **params) -> str | None:
    """Cache file path for a built preconditioner, keyed on the mesh's
    numerical identity (connectivity + geometry incl. METRIC TERMS + masks),
    the dt scale and the build parameters. Same directory as the mesh cache.

    mesh.g must be in the key: the cached eb_w blocks are used as the real
    pressure operator (navier_stokes.make_pressure_solver), and two meshes
    with identical connectivity/mass matrices but different metrics (sheared
    vs straight elements of equal jacobian) define different E (ADVICE r4)."""
    import hashlib
    import os

    if os.environ.get("NEKLAB_PRECOND_CACHE", "1") == "0":
        return None
    h = hashlib.sha256()
    for arr in (mesh.gidx, mesh.bm1, mesh.bm2, mesh.binv, mesh.vmask,
                mesh.pmask, mesh.g):
        a = np.asarray(arr)
        h.update(a.tobytes())
        h.update(str(a.dtype).encode())
    h.update(repr((_PC_FORMAT, float(dt_over_g0), int(mesh.p_fixed),
                   sorted(params.items()))).encode())
    from ..mesh.cache import default_cache_dir

    return os.path.join(default_cache_dir(), f"pc_{h.hexdigest()[:24]}.npz")


def _pc_save(path: str, pc: "ETwoLevel") -> None:
    import os

    data = {}
    for name in _PC_FIELDS:
        v = getattr(pc, name)
        if v is not None:
            # npz cannot hold bfloat16 directly; store via uint16 view
            a = np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v)
            data[name] = a
            data[name + "__bf16"] = np.asarray(v.dtype == jnp.bfloat16)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + f".tmp{os.getpid()}.npz"
    np.savez(tmp, **data)
    os.replace(tmp, path)


def _pc_load(path: str) -> "ETwoLevel":
    with np.load(path) as z:
        kw = {}
        for name in _PC_FIELDS:
            if name in z.files:
                a = jnp.asarray(z[name])
                if bool(z[name + "__bf16"]):
                    a = a.astype(jnp.bfloat16)
                kw[name] = a
            else:
                kw[name] = None
    return ETwoLevel(**kw)


def build_e_preconditioner(
    mesh: SemMesh,
    dt_over_g0: float,
    coarse_max_dense: int = 4096,
    local: str | None = None,
    exact_blocks: bool | None = None,
    compress: bool | None = None,
    coarse: str | None = None,
) -> ETwoLevel:
    """Host-level construction (jitted probing inside). Cache per (mesh, dt).

    coarse_max_dense: largest coarse problem kept as a dense inverse; meshes
    with more elements get an RCB-aggregated coarse space of that size (see
    module docstring).

    local: "bj" (per-element block Jacobi, cheapest apply) or "oas"
    (overlapping additive Schwarz over face-neighbor patches; the overlap
    is what lets the q1 coarse bite — measured on the production cylinder
    mesh: bj+const 240 cold E iterations, oas+q1 49). Default (None): "oas"
    on 2-D meshes at or below coarse_max_dense (the production path),
    "bj" otherwise (3-D patch memory is P^2 x larger).

    exact_blocks: also attach the EXACT neighbor-block form of E itself
    (ETwoLevel.eb_w/eb_nbr; see class docstring) so the pressure solver can
    apply E as gather+einsum instead of the long matrix-free kernel chain.
    Default (None): enabled for 2-D meshes where the block memory is modest.
    Both "oas" and exact_blocks reuse one distance-3-colored probing pass.

    compress: store the LOCAL preconditioner matrices (blocks_inv /
    oas_binv — NOT the exact operator blocks eb_w, and NOT the coarse
    inverse ec_inv, whose conditioning makes bf16 rounding SPD-unsafe) in
    bfloat16, halving the dominant per-CG-iteration HBM traffic at
    negligible accuracy cost (the preconditioner only shapes the search
    directions; see tests/test_precond.py bf16-iteration-parity test).
    Default: on for f32 meshes (chosen before the port to the H100; not
    measured there), off for f64.

    coarse: "q1" (continuous-bilinear hats on element-corner vertices,
    E_c = P^T E P assembled exactly from the probed neighbor blocks — the
    inter-element-continuous Poisson coarse space; ~2-3x fewer CG
    iterations than the constant space) or "const" (piecewise constants,
    works in any dimension and feeds the RCB-aggregated tier above
    coarse_max_dense). Default (None): "q1" on 2-D meshes whose neighbor
    blocks are probed anyway (exact_blocks / oas), "const" otherwise."""
    np2 = int(np.prod(mesh.bm2.shape[:-1]))  # pressure pts per element (element-last)
    nel = mesh.nel
    dtype = mesh.bm2.dtype

    # persistent build cache (the colored probing + patch inversion costs
    # ~2 min on the production mesh; reference analog: XXT setup is also
    # build-once-use-many)
    cache_path = _pc_cache_path(
        mesh, dt_over_g0, coarse_max_dense=coarse_max_dense, local=str(local),
        exact_blocks=str(exact_blocks), compress=str(compress),
        coarse=str(coarse))
    if cache_path is not None:
        import os as _os

        if _os.path.exists(cache_path):
            try:
                return _pc_load(cache_path)
            except Exception:
                pass

    eop = jax.jit(lambda q: stokes.e_op(mesh, q, dt_over_g0))

    # native (C++) adjacency/coloring when available — the Python fallback is
    # O(slow) at production element counts (SURVEY 2.2: gslib-setup analog)
    from .. import native

    gidx_el = np.asarray(mesh.gidx).reshape(-1, mesh.nel).T
    nat = native.adjacency_colorings(gidx_el, nel)
    adj = element_adjacency(mesh)
    if nat is not None:
        colors2, colors3_nat = nat
    else:
        colors2 = greedy_coloring(adj)
        colors3_nat = None
    ncol2 = int(colors2.max()) + 1

    # ---- local blocks by colored probing ----
    # probe (color c, pattern j): e_q = 1 at pattern j of every color-c
    # element. Patterns are probed in vmapped BATCHES — one device call per
    # (color, chunk) instead of per (color, pattern) — and the blocks are
    # assembled AND inverted on device: no O(nel * np2^2) host transfers,
    # which dominate the 3-D setup on remote-device links.
    color_mask = jnp.asarray((colors2[:, None] == np.arange(ncol2)[None, :]).astype(np.float64)).astype(dtype)  # [nel, ncol]

    # chunk so the probe batch stays under ~128 MB
    chunk = max(1, min(np2, int(128e6 / (np2 * nel * 4))))

    @jax.jit
    def probe_chunk_dev(blocks_dev, pats, cmask, j0):
        q = pats[:, :, None] * cmask[None, None, :]  # [chunk, np2, nel]
        out = jax.vmap(eop)(q.reshape((pats.shape[0],) + mesh.bm2.shape))
        cols = out.reshape(pats.shape[0], np2, nel)  # [m(j), np2(i), nel]
        # accumulate columns j0..j0+chunk of every color-c element's block;
        # other elements' columns receive their aliased values but are
        # overwritten when their own color is probed (mask makes them exact:
        # multiply by cmask so off-color elements contribute zero)
        upd = jnp.moveaxis(cols * cmask[None, None, :], -1, 0)  # [nel, np2, m]
        return jax.lax.dynamic_update_slice(
            blocks_dev, blocks_dev_slice_add(blocks_dev, upd, j0), (0, 0, j0)
        )

    def blocks_dev_slice_add(blocks_dev, upd, j0):
        cur = jax.lax.dynamic_slice(blocks_dev, (0, 0, j0), upd.shape)
        return cur + upd

    # pad the column axis to a chunk multiple so dynamic_update_slice never
    # clamps (clamping would misalign the final chunk)
    np2_pad = ((np2 + chunk - 1) // chunk) * chunk
    blocks_dev = jnp.zeros((nel, np2, np2_pad), dtype)
    for c in range(ncol2):
        for j0 in range(0, np2, chunk):
            m = min(chunk, np2 - j0)
            pats = jnp.zeros((chunk, np2), dtype).at[
                jnp.arange(chunk),
                jnp.clip(jnp.arange(j0, j0 + chunk), 0, np2 - 1),
            ].set(jnp.where(jnp.arange(chunk) < m, 1.0, 0.0))
            blocks_dev = probe_chunk_dev(blocks_dev, pats, color_mask[:, c], j0)
    blocks_dev = blocks_dev[:, :, :np2]

    # symmetrize (probing is exact, this guards roundoff), regularize (the
    # all-Neumann global constant can make the aggregate nearly singular on
    # tiny meshes), and invert — all batched on device
    @jax.jit
    def finalize(b):
        b = 0.5 * (b + jnp.swapaxes(b, 1, 2))
        tr = jnp.trace(b, axis1=1, axis2=2) / np2
        b = b + (1e-8 * jnp.maximum(tr, 1e-30))[:, None, None] * jnp.eye(np2, dtype=b.dtype)[None]
        return jnp.linalg.inv(b)

    blocks_inv = finalize(blocks_dev)

    # ---- resolve the exact-blocks default and the coarse-space mode ----
    if exact_blocks is None:
        K_est = 1 + max((len(s) for s in adj), default=0)
        exact_blocks = (
            mesh.ndim == 2 and nel <= coarse_max_dense
            and nel * K_est * np2 * np2 * 4 < 256e6
        )
    if local is None:
        local = "oas" if (mesh.ndim == 2 and nel <= coarse_max_dense) else "bj"
    if coarse is None:
        coarse = (
            "q1"
            if mesh.ndim == 2 and nel <= coarse_max_dense
            and (exact_blocks or local == "oas")
            else "const"
        )
    if coarse == "q1" and (mesh.ndim != 2 or nel > coarse_max_dense):
        raise ValueError(
            "coarse='q1' requires a 2-D mesh with nel <= coarse_max_dense "
            f"(got ndim={mesh.ndim}, nel={nel})")

    # ---- element grouping + distance-3 colorings (shared by the const
    # coarse probing and the neighbor-block probing) ----
    if nel <= coarse_max_dense:
        group_of_el = np.arange(nel)
        ngrp = nel
        gadj = adj
        colors3 = colors3_nat if colors3_nat is not None else greedy_coloring(
            _square_adjacency(adj))
    else:
        ngrp = coarse_max_dense
        # element centroids in ELEMENT-LAST layout: x is [ndim, pts..., nel]
        xs = np.asarray(mesh.x).reshape(mesh.ndim, -1, nel)
        centroids = np.ascontiguousarray(xs.mean(axis=1).T)  # [nel, ndim]
        from ..mesh.re2 import rcb_order

        order = rcb_order(centroids, ngrp)  # native C++ RCB when available
        group_of_el = np.empty(nel, dtype=np.int64)
        bounds = np.linspace(0, nel, ngrp + 1).astype(int)
        for g in range(ngrp):
            group_of_el[order[bounds[g]:bounds[g + 1]]] = g
        gadj = [set() for _ in range(ngrp)]
        for e, nb in enumerate(adj):
            ge = int(group_of_el[e])
            for u in nb:
                gu = int(group_of_el[u])
                if gu != ge:
                    gadj[ge].add(gu)
        colors3 = greedy_coloring(_square_adjacency(gadj))

    # ---- exact neighbor blocks of E (needed by eb / oas / q1) ----
    W = nbr = slot = nbrs_list = None
    eb_w = eb_nbr = None
    if exact_blocks or local == "oas" or coarse == "q1":
        colors3_el = (
            colors3 if ngrp == nel
            else greedy_coloring(_square_adjacency(adj))
        )
        W, nbr, slot, nbrs_list = _probe_e_blocks(mesh, adj, colors3_el)
        if exact_blocks:
            eb_w = jnp.asarray(W, dtype)
            eb_nbr = jnp.asarray(nbr, jnp.int32)

    # ---- coarse space assembly ----
    q1 = {}
    if coarse == "q1":
        # vertex ids from the element-corner GLOBAL velocity DOFs (periodic
        # identification rides along); element-last gidx is [n(s), n(r), nel]
        g = np.asarray(mesh.gidx)
        corners = np.stack(
            [g[0, 0], g[0, -1], g[-1, 0], g[-1, -1]], axis=1)  # [nel, 4]
        uniq, vid = np.unique(corners.reshape(-1), return_inverse=True)
        q1_vert = vid.reshape(nel, 4)
        nvert = len(uniq)
        # bilinear hats at the mesh-2 (interior GLL) points, s-major flatten;
        # column order matches the corner order (s-,r-),(s-,r+),(s+,r-),(s+,r+)
        z2 = np.asarray(mesh.basis.z2)
        hm, hp = (1.0 - z2) / 2.0, (1.0 + z2) / 2.0
        b4 = np.stack([np.outer(a, b).reshape(-1)
                       for a, b in ((hm, hm), (hm, hp), (hp, hm), (hp, hp))],
                      axis=1)  # [np2, 4]
        ec = np.zeros((nvert, nvert))
        for e in range(nel):
            ve = q1_vert[e]
            for m, f in enumerate(nbrs_list[e]):
                blk = b4.T @ W[e, m] @ b4  # [4, 4]
                # np.add.at, not fancy-indexed +=: periodic identification
                # can collapse two corners of one element to the SAME vertex
                # id (mesh one element wide across a periodic direction), and
                # += silently drops duplicate contributions (ADVICE r4)
                rows = np.repeat(ve, 4)
                cols = np.tile(q1_vert[f], 4)
                np.add.at(ec, (rows, cols), blk.reshape(-1))
        ec = 0.5 * (ec + ec.T)
        if mesh.p_fixed:
            # constants (in vertex space) span the nullspace; sigma-shift so
            # the dense inverse acts as a bounded pseudo-inverse on it
            sigma = np.abs(np.diag(ec)).mean()
            ec = ec + sigma * np.ones((nvert, nvert)) / nvert
        ec_inv = np.linalg.inv(ec)
        group_of_el = np.arange(nel)  # q1 never aggregates
        ngrp = nel
        q1 = dict(q1_vert=jnp.asarray(q1_vert, jnp.int32),
                  q1_b4=jnp.asarray(b4, dtype))
    else:
        ncol3 = int(colors3.max()) + 1
        el_color = colors3[group_of_el]  # per-element color of its group
        ec = np.zeros((ngrp, ngrp))
        ones_pat = jnp.ones((np2,), dtype)

        # support of E R_a^T 1_g = g's elements and their neighbors; with
        # distance-3 coloring of the GROUP graph, same-color probe supports
        # are disjoint, so group-restricted row sums attribute uniquely
        nbr_plus = [set([g]) | gadj[g] for g in range(ngrp)]
        # all colors probed on device, ONE stacked host transfer (see the
        # same batching note in _probe_e_blocks)
        cmask_all = jnp.asarray(
            (el_color[None, :] == np.arange(ncol3)[:, None]).astype(np.float64)
        ).astype(dtype)  # [ncol3, nel]

        def coarse_probe(mask_c):
            q = ones_pat[:, None] * mask_c[None, :]  # [np2, nel]
            return eop(q.reshape(mesh.bm2.shape)).reshape(np2, nel).sum(axis=0)

        outs_el = np.asarray(jax.lax.map(coarse_probe, cmask_all))  # [ncol3, nel]
        for c in range(ncol3):
            out = np.zeros(ngrp)
            np.add.at(out, group_of_el, outs_el[c])  # R_a of the probe response
            for g in np.nonzero(colors3 == c)[0]:
                for g2 in nbr_plus[g]:
                    ec[g2, g] = out[g2]
        ec = 0.5 * (ec + ec.T)
        # nullspace: constants (enclosed flows). Shift the constant mode by a
        # O(diag)-sized sigma so E_c^-1 acts like a pseudo-inverse with a
        # modest (1/sigma) response on the nullspace; the solver projects it
        # out anyway.
        if mesh.p_fixed:
            sigma = np.abs(np.diag(ec)).mean()
            ec = ec + sigma * np.ones((ngrp, ngrp)) / ngrp
        ec_inv = np.linalg.inv(ec)

    # ---- OAS patch solves (reuse the probed blocks) ----
    oas = {}
    if local == "oas":
        fadj = face_adjacency(mesh)
        patches = [[e] + sorted(fadj[e]) for e in range(nel)]
        P = max(len(p) for p in patches)
        nb2 = P * np2
        B = np.zeros((nel, nb2, nb2))
        gin = np.zeros((nel, P), np.int64)
        win = np.zeros((nel, P))
        # multiplicity of element f's DOFs across patches = 1 + deg(f)
        mult = np.array([1 + len(fadj[f]) for f in range(nel)], float)
        wsq = 1.0 / np.sqrt(mult)
        for e, pat in enumerate(patches):
            for m, g2 in enumerate(pat):
                gin[e, m] = g2
                win[e, m] = wsq[g2]
                for m2, f in enumerate(pat):
                    s2 = slot.get((g2, f))
                    if s2 is not None:
                        B[e, m * np2:(m + 1) * np2, m2 * np2:(m2 + 1) * np2] = W[g2, s2]
            # identity on pad slots keeps the patch matrix invertible
            for m in range(len(pat), P):
                gin[e, m] = e
                sl = slice(m * np2, (m + 1) * np2)
                B[e, sl, sl] = np.eye(np2)
        B = 0.5 * (B + np.swapaxes(B, 1, 2))
        tr = np.trace(B, axis1=1, axis2=2) / nb2
        B += (1e-8 * np.maximum(tr, 1e-30))[:, None, None] * np.eye(nb2)[None]
        # NOTE: inverted on the HOST in f64 deliberately: for an f32 mesh a
        # device inversion would run in f32, and the patch blocks are
        # ill-conditioned enough that the inverse would lose several digits
        # before the bf16 compression even starts.
        binv = np.linalg.inv(B)
        # reverse map: element f's own piece sits at slot 0 of its own
        # patch and at slot pos(f in patch(g)) of each face-neighbor g
        rev = np.zeros((nel, P), np.int64)
        wout = np.zeros((nel, P))
        for f in range(nel):
            entries = [(f, 0)]
            for g2 in sorted(fadj[f]):
                entries.append((g2, patches[g2].index(f)))
            for k, (g2, m) in enumerate(entries):
                rev[f, k] = g2 * P + m
                wout[f, k] = wsq[f]
            for k in range(len(entries), P):
                rev[f, k] = f * P + 0  # pad: gathers own slot, weight 0
        oas = dict(
            oas_binv=jnp.asarray(binv, dtype),
            oas_gin=jnp.asarray(gin, jnp.int32),
            oas_win=jnp.asarray(win, dtype),
            oas_rev=jnp.asarray(rev, jnp.int32),
            oas_wout=jnp.asarray(wout, dtype),
        )

    if compress is None:
        compress = dtype == jnp.float32
    pdtype = jnp.bfloat16 if compress else dtype
    if "oas_binv" in oas:
        oas["oas_binv"] = oas["oas_binv"].astype(pdtype)
    # NOTE: ec_inv is kept at FULL precision always. The coarse operator's
    # condition number grows with mesh size (it is a homogenized Poisson
    # problem), and rounding a symmetric inverse to bf16 (eps ~ 7.8e-3) can
    # lose positive-definiteness once kappa exceeds ~1/eps — an indefinite
    # term would silently break the SPD assumption of PCG. (Measured on the
    # production cylinder mesh: bf16 ec_inv COSTS iterations — 334 vs 252
    # cold — on top of the risk.) The LOCAL blocks (per-element / per-patch,
    # kappa bounded by the element problem) are safe to compress, and carry
    # much of the per-iteration HBM traffic.
    pc = ETwoLevel(
        blocks_inv=jnp.asarray(blocks_inv, pdtype),
        ec_inv=jnp.asarray(ec_inv, dtype),
        agg_of_el=jnp.asarray(group_of_el, jnp.int32) if ngrp < nel else None,
        eb_w=eb_w,
        eb_nbr=eb_nbr,
        **q1,
        **oas,
    )
    if cache_path is not None:
        try:
            _pc_save(cache_path, pc)
        except Exception:
            pass
    return pc
