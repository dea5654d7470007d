"""Device-side SEM mesh container.

`SemMesh` bundles everything a jitted kernel needs: geometric factors, the
gather-scatter (direct-stiffness) numbering, multiplicity weights, and the
per-field Dirichlet masks. It is a registered pytree so it can be closed over
or passed through jit/scan; the basis and sizes are static aux data.

Reference parity: the union of Nek5000's GEOM/MASS commons (bm1, jacm1,
g1m1..g6m1), the gslib gather-scatter handle (dssum/dsavg semantics of
/root/reference/src/vectors/real_vectors.f90:100-104), and the v1mask/pmask
boundary masks used by `bcdirvc`.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..ops.basis import Basis
from ..ops.geometry import GeomFactors
from ..utils.pytrees import pytree_dataclass


@pytree_dataclass(
    meta_fields=(
        "basis", "ndim", "nel", "nglob", "bc", "fp_nvert",
        "fp_roll_off", "vs_roll_off",
    )
)
class SemMesh:
    basis: Basis
    ndim: int
    nel: int
    nglob: int
    bc: tuple  # tuple of (face-set name, bc-char) pairs — static metadata
    # geometry (compute dtype)
    x: jnp.ndarray  # [ndim, nel, ...]
    jac: jnp.ndarray  # [nel, ...]
    rx: jnp.ndarray  # [ndim, ndim, nel, ...]
    bm1: jnp.ndarray  # [nel, ...]
    g: jnp.ndarray  # [ndim, ndim, nel, ...]
    xd: jnp.ndarray  # [ndim, nel, ...d]
    rxd: jnp.ndarray  # [ndim, ndim, nel, ...d]
    bmd: jnp.ndarray  # [nel, ...d]
    bm2: jnp.ndarray  # [nel, ...2] pressure-grid mass
    binv: jnp.ndarray  # [nel, ...] inverse of the assembled (diagonal) mass
    # connectivity
    gidx: jnp.ndarray  # int32 [pts..., nel] global DOF ids
    gfirst: jnp.ndarray  # int32 [nglob] flat position of one copy of each DOF
    vmult: jnp.ndarray  # [pts..., nel] 1/multiplicity
    # masks: 1.0 on free DOFs, 0.0 on constrained DOFs
    vmask: jnp.ndarray  # [ndim, nel, ...] velocity component masks
    pmask: jnp.ndarray  # [nel, ...] pressure mask (0 where p Dirichlet, e.g. outflow)
    tmask: jnp.ndarray  # [nel, ...] temperature/scalar mask
    vmask_hat: jnp.ndarray  # [ndim, nglob] global-DOF velocity masks
    tmask_hat: jnp.ndarray  # [nglob] global-DOF scalar mask
    volume: jnp.ndarray  # scalar: total mesh volume
    # face-pair exchange schedule for UNSTRUCTURED conforming 2-D meshes
    # (None on structured/3-D meshes): partner face-column gather indices,
    # orientation flips, interior mask, and compact vertex ids — see
    # ops.sem._dssum_facepair. Gathering only the face strips was cheaper
    # than the general global scatter-add on the earlier accelerator (not
    # measured on the H100).
    fp_pidx: jnp.ndarray | None = None  # int32 [4*nel] partner flat face index
    fp_flip: jnp.ndarray | None = None  # bool [4*nel] partner runs reversed
    fp_mask: jnp.ndarray | None = None  # [4*nel] 1.0 interior face, 0.0 boundary
    fp_vsib: jnp.ndarray | None = None  # int32 [maxmult-1, 4*nel] vertex sibling copies (pad 4*nel)
    fp_nvert: int = 0  # static: number of unique vertices
    # element permutation when the builder reordered elements for partition
    # locality (RCB): arr_here = arr_file_order[..., eperm]. None = identity.
    eperm: jnp.ndarray | None = None  # int32 [nel]
    # roll-decomposed exchange plans (see _roll_plan): mapped-multiblock
    # meshes pair >90% of faces at a few constant index offsets, so the
    # face/vertex gathers (the dssum bottleneck on the earlier accelerator;
    # not measured on the H100) become masked rolls XLA fuses into shifted
    # reads, plus a tiny remainder gather/scatter. Offsets are STATIC (meta).
    fp_roll_mask: jnp.ndarray | None = None  # [Ke, 4*nel]
    fp_rem_dst: jnp.ndarray | None = None  # int32 [Re]
    fp_rem_src: jnp.ndarray | None = None  # int32 [Re]
    vs_roll_mask: jnp.ndarray | None = None  # [Kv, 4*nel]
    vs_rem_dst: jnp.ndarray | None = None  # int32 [Rv]
    vs_rem_src: jnp.ndarray | None = None  # int32 [Rv]
    fp_roll_off: tuple = ()  # static: face-exchange roll offsets [Ke]
    vs_roll_off: tuple = ()  # static: vertex-sum roll offsets [Kv]

    @property
    def npts(self) -> int:
        return self.basis.n**self.ndim

    @property
    def p_fixed(self) -> bool:
        """True when the pressure Poisson problem has no Dirichlet DOF
        (pure Neumann -> nullspace must be projected out)."""
        return bool(self._p_all_neumann)

    # stored as a static-friendly int in bc metadata instead; see builder.
    @property
    def _p_all_neumann(self):
        return ("__pure_neumann__", "1") in self.bc


def build_mesh(
    geom: GeomFactors,
    basis: Basis,
    gidx: np.ndarray,
    vmask: np.ndarray,
    pmask: np.ndarray,
    tmask: np.ndarray | None = None,
    bc: tuple = (),
    dtype=jnp.float64,
    eperm: np.ndarray | None = None,
) -> SemMesh:
    """Finalize host-side geometry + connectivity into a device SemMesh.

    Inputs use the builder-friendly ELEMENT-FIRST layout ([.., nel, pts..]);
    the stored device arrays are transposed to the ELEMENT-LAST
    layout ([.., pts.., nel]) — see ops/tensor.py.
    """
    ndim = geom.ndim
    nel = geom.x.shape[1]
    gidx = np.asarray(gidx, dtype=np.int32)
    nglob = int(gidx.max()) + 1

    # multiplicity: how many element-local copies each global DOF has
    ones = np.ones(gidx.size)
    cnt = np.zeros(nglob)
    np.add.at(cnt, gidx.reshape(-1), ones)
    vmult = (1.0 / cnt)[gidx.reshape(-1)].reshape(gidx.shape)

    if tmask is None:
        tmask = np.ones_like(pmask)

    # assembled mass diagonal (dssum of bm1) and its inverse, per node copy
    bsum = np.zeros(nglob)
    np.add.at(bsum, gidx.reshape(-1), geom.bm1.reshape(-1))
    binv = (1.0 / bsum)[gidx.reshape(-1)].reshape(gidx.shape)

    # global-DOF masks (min over copies: Dirichlet wins at shared nodes)
    ndim_ = geom.ndim
    vmask_hat = np.ones((ndim_, nglob))
    for c in range(ndim_):
        np.minimum.at(vmask_hat[c], gidx.reshape(-1), vmask[c].reshape(-1))
    tmask_hat = np.ones(nglob)
    np.minimum.at(tmask_hat, gidx.reshape(-1), tmask.reshape(-1))

    # Make the LOCAL masks copy-consistent: scatter the min-over-copies
    # global masks back onto every element copy (Nek's dsop-MUL on masks).
    # The weighted-local CG operator in helmholtz_solve is symmetric and
    # enforces Dirichlet values only if all copies of a shared DOF agree —
    # meshes with mid-boundary BC transitions (W next to SYM/O) or boundary
    # vertex fans otherwise produce copy-inconsistent masks.
    vmask = np.stack([vmask_hat[c][gidx] for c in range(ndim_)])
    tmask = tmask_hat[gidx]

    pure_neumann = bool(np.all(pmask > 0.5))
    bc = tuple(bc) + ((("__pure_neumann__", "1"),) if pure_neumann else ())


    def el_last(a: np.ndarray, nel_axis: int) -> np.ndarray:
        return np.ascontiguousarray(np.moveaxis(a, nel_axis, -1))

    cast = lambda a: jnp.asarray(a, dtype=dtype)
    # first-copy position of every global DOF in the ELEMENT-LAST flattening
    gidx_el_last = np.moveaxis(gidx, 0, -1).reshape(-1)
    _, first_pos = np.unique(gidx_el_last, return_index=True)

    structured = any(k == "__struct__" for k, _ in bc)
    fp = None
    fp_plan = vs_plan = None
    if ndim == 2 and not structured:
        fp = _facepair_schedule(gidx)
        if fp is not None:
            nface = 4 * nel
            fp_plan = _roll_plan(np.asarray(fp[0]), nface)
            # vertex-sum plan: merge the per-sibling-row maps (the sum over
            # rows becomes one accumulation of masked rolls + a scatter-ADD
            # remainder; pad index nface is skipped by _roll_plan)
            vsib = np.asarray(fp[3])
            acc: dict[int, np.ndarray] = {}
            rdst, rsrc = [], []
            for r in range(vsib.shape[0]):
                offs, masks, rd, rs = _roll_plan(vsib[r], nface)
                for k, m in zip(offs, masks):
                    acc[k] = acc.get(k, 0.0) + m
                rdst.append(rd)
                rsrc.append(rs)
            vs_off = tuple(sorted(acc))
            vs_masks = (
                np.stack([acc[k] for k in vs_off]) if vs_off else np.zeros((0, nface))
            )
            vs_plan = (
                vs_off,
                vs_masks,
                np.concatenate(rdst) if rdst else np.zeros(0, np.int32),
                np.concatenate(rsrc) if rsrc else np.zeros(0, np.int32),
            )
    return SemMesh(
        basis=basis,
        ndim=ndim,
        nel=nel,
        nglob=nglob,
        bc=bc,
        x=cast(el_last(geom.x, 1)),
        jac=cast(el_last(geom.jac, 0)),
        rx=cast(el_last(geom.rx, 2)),
        bm1=cast(el_last(geom.bm1, 0)),
        g=cast(el_last(geom.g, 2)),
        xd=cast(el_last(geom.xd, 1)),
        rxd=cast(el_last(geom.rxd, 2)),
        bmd=cast(el_last(geom.bmd, 0)),
        bm2=cast(el_last(geom.bm2, 0)),
        binv=cast(el_last(binv, 0)),
        gidx=jnp.asarray(el_last(gidx, 0)),
        gfirst=jnp.asarray(first_pos.astype(np.int32)),
        vmult=cast(el_last(vmult, 0)),
        vmask=cast(el_last(vmask, 1)),
        pmask=cast(el_last(pmask, 0)),
        tmask=cast(el_last(tmask, 0)),
        vmask_hat=cast(vmask_hat),
        tmask_hat=cast(tmask_hat),
        volume=cast((geom.bm1).sum()),
        fp_pidx=jnp.asarray(fp[0]) if fp else None,
        fp_flip=jnp.asarray(fp[1]) if fp else None,
        fp_mask=cast(fp[2]) if fp else None,
        fp_vsib=jnp.asarray(fp[3]) if fp else None,
        fp_nvert=fp[4] if fp else 0,
        eperm=jnp.asarray(np.asarray(eperm, np.int32)) if eperm is not None else None,
        fp_roll_mask=cast(fp_plan[1]) if fp_plan else None,
        fp_rem_dst=jnp.asarray(fp_plan[2]) if fp_plan else None,
        fp_rem_src=jnp.asarray(fp_plan[3]) if fp_plan else None,
        vs_roll_mask=cast(vs_plan[1]) if vs_plan else None,
        vs_rem_dst=jnp.asarray(vs_plan[2]) if vs_plan else None,
        vs_rem_src=jnp.asarray(vs_plan[3]) if vs_plan else None,
        fp_roll_off=fp_plan[0] if fp_plan else (),
        vs_roll_off=vs_plan[0] if vs_plan else (),
    )


def from_file_order(mesh: SemMesh, arr):
    """Map an element-LAST array in FILE (global .re2/.fld) element order onto
    this mesh's element order (identity unless the mesh was built with RCB
    partition reordering)."""
    if mesh.eperm is None:
        return arr
    return jnp.asarray(np.asarray(arr)[..., np.asarray(mesh.eperm)])


def _roll_plan(idx: np.ndarray, length: int, kmax: int = 32, min_count: int = 8):
    """Decompose the index map out[j] = src[idx[j]] (positions with
    idx[j] >= length are ignored — padding) into K constant-offset rolls
    plus a remainder:

        out = sum_k mask_k * roll(src, -d_k)  ;  out[rem_dst] = src[rem_src]

    Mapped-multiblock meshes concentrate >90% of face/vertex partners on a
    handful of offsets (measured: 20 offsets cover 98% of the reference
    1cyl mesh), so this turns the arbitrary gather into fused shifted
    reads (chosen before the port to the H100; not measured there).
    Returns (offsets tuple, masks [K, length] f64,
    rem_dst int32, rem_src int32)."""
    idx = np.asarray(idx)
    j = np.arange(len(idx))
    valid = idx < length
    d = idx - j
    vals, counts = np.unique(d[valid], return_counts=True)
    order = np.argsort(-counts, kind="stable")
    sel = [int(vals[i]) for i in order[:kmax] if counts[i] >= min_count]
    masks = []
    covered = np.zeros(len(idx), bool)
    for k in sorted(sel):
        m = valid & (d == k)
        masks.append(m.astype(np.float64))
        covered |= m
    rem = np.nonzero(valid & ~covered)[0]
    offs = tuple(sorted(sel))
    mask_arr = np.stack(masks) if masks else np.zeros((0, len(idx)))
    return offs, mask_arr, rem.astype(np.int32), idx[rem].astype(np.int32)


def _facepair_schedule(gidx: np.ndarray):
    """Face-pairing exchange schedule for a conforming 2-D mesh.

    gidx: [nel, n(s), n(r)] global ids (element-first builder layout). Faces
    are stacked in the fixed order (s-, s+, r-, r+) and flattened as
    flat = face * nel + e, matching the element-LAST [n, 4, nel] stacking in
    ops.sem._dssum_facepair. Returns None if any face is shared by more than
    two elements (non-conforming: fall back to the scatter path).
    """
    nel, n, _ = gidx.shape
    seqs = np.empty((4, nel, n), dtype=np.int64)
    seqs[0] = gidx[:, 0, :]  # s- (r varies)
    seqs[1] = gidx[:, -1, :]  # s+
    seqs[2] = gidx[:, :, 0]  # r- (s varies)
    seqs[3] = gidx[:, :, -1]  # r+

    owners: dict = {}
    for f in range(4):
        for e in range(nel):
            key = tuple(sorted(seqs[f, e]))
            owners.setdefault(key, []).append((f, e))

    pidx = np.arange(4 * nel, dtype=np.int32)  # default: self (boundary)
    flip = np.zeros(4 * nel, dtype=bool)
    mask = np.zeros(4 * nel, dtype=np.float64)
    for key, faces in owners.items():
        if len(faces) == 1:
            continue
        if len(faces) > 2:
            return None  # non-conforming
        (fa, ea), (fb, eb) = faces
        ia, ib = fa * nel + ea, fb * nel + eb
        pidx[ia], pidx[ib] = ib, ia
        mask[ia] = mask[ib] = 1.0
        same = bool(np.all(seqs[fa, ea] == seqs[fb, eb]))
        rev = bool(np.all(seqs[fa, ea] == seqs[fb, eb][::-1]))
        if not (same or rev):
            return None  # conforming faces must match directly or reversed
        flip[ia] = flip[ib] = rev

    # vertices: sibling-copy gather schedule. Corner c of element e sits at
    # flat position c * nel + e (order s-r-, s-r+, s+r-, s+r+); each copy
    # lists the flat positions of its OTHER copies, padded with index 4*nel
    # (a zero slot appended at apply time) — all-gather arithmetic, no
    # scatter.
    corners = np.stack(
        [gidx[:, 0, 0], gidx[:, 0, -1], gidx[:, -1, 0], gidx[:, -1, -1]]
    ).reshape(-1)
    uniq, vgid = np.unique(corners, return_inverse=True)
    copies: list[list[int]] = [[] for _ in range(len(uniq))]
    for pos, v in enumerate(vgid):
        copies[v].append(pos)
    maxmult = max(len(c) for c in copies)
    vsib = np.full((maxmult - 1, 4 * nel), 4 * nel, dtype=np.int32)  # pad slot
    for c in copies:
        for j, pos in enumerate(c):
            others = [p for p in c if p != pos]
            vsib[: len(others), pos] = others
    return pidx, flip, mask, vsib, int(len(uniq))
