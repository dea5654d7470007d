"""Wavenumber-projected exponential propagator (exptA_proj).

For streamwise-periodic flows: restricts the propagator to a single Fourier
wavenumber alpha by projecting onto span{cos(alpha x), sin(alpha x)} with
streamwise plane averaging, before AND after the time integration:

  M_alpha = P_alpha exp(tau A) P_alpha.

Reference parity: `exptA_proj_linop`
(/root/reference/src/linops/exponential_propagator_proj.f90): cv/sv basis +
`gtpp_gs_setup`/`planar_avg` tensor-product-plane reduction, proj_alpha
(:135-173). Here, on a structured box mesh the plane average is a
weighted einsum over the (element-x, node-x) axes — a pure device reduction
(sharded meshes: XLA inserts the psum over the element axis).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..krylov.linop import LinearOperator
from ..mesh.core import SemMesh
from .exponential_propagator import ExponentialPropagator


def _box_shape(mesh: SemMesh) -> tuple[int, ...]:
    for k, v in mesh.bc:
        if k == "__box__":
            return tuple(int(t) for t in v.split("x"))
    raise ValueError("mesh has no structured-box metadata (__box__)")


class ProjectedPropagator(LinearOperator):
    """M_alpha = P exp(tau A) P over {u, theta} vectors.

    Valid for tensor-product (undeformed) 2-D box meshes, periodic in x;
    the x-line quadrature weights come from the mesh coordinates + GLL rule.
    """

    def __init__(self, exptA: ExponentialPropagator, alpha: float):
        self.exptA = exptA
        mesh = exptA.mesh
        self.mesh = mesh
        if mesh.ndim != 2:
            raise NotImplementedError("ProjectedPropagator: 2-D for now")
        nelx, nely = _box_shape(mesh)
        n = mesh.basis.n
        # element-last layout: field [.., j, i, nel] with nel C-ordered (ey, ex)
        self.shape_el = (n, n, nely, nelx)
        x = np.asarray(mesh.x[0]).reshape(self.shape_el)
        dxe = x[0, -1, 0, :] - x[0, 0, 0, :]  # [nelx] element widths
        w = np.asarray(mesh.basis.w)
        self.wx = jnp.asarray((dxe[:, None] / 2.0) * w[None, :], mesh.bm1.dtype)  # [nelx, n_i]
        self.lx = float(dxe.sum())
        xj = jnp.asarray(x, mesh.bm1.dtype)
        self.cv = jnp.cos(alpha * xj)  # [j, i, ney, nex]
        self.sv = jnp.sin(alpha * xj)
        self.alpha = float(alpha)
        # ||cos(alpha x)||^2 over a full period = Lx/2 (alpha = 0: Lx)
        self.cnorm = self.lx if alpha == 0.0 else self.lx / 2.0
        self._proj = jax.jit(self._project)

    @property
    def tau(self):
        return self.exptA.tau

    def _project_field(self, f: jnp.ndarray) -> jnp.ndarray:
        """[..., j, i, nel] -> projection onto the alpha mode (same shape)."""
        lead = f.shape[:-3]
        g = f.reshape(lead + self.shape_el)
        hi = precision="highest"
        a = jnp.einsum("...jiyx,xi,jiyx->...jy", g, self.wx, self.cv, precision=hi) / self.cnorm
        rec = jnp.einsum("...jy,jiyx->...jiyx", a, self.cv, precision=hi)
        if self.alpha != 0.0:
            b = jnp.einsum("...jiyx,xi,jiyx->...jy", g, self.wx, self.sv, precision=hi) / self.cnorm
            rec = rec + jnp.einsum("...jy,jiyx->...jiyx", b, self.sv, precision=hi)
        return rec.reshape(f.shape)

    def _project(self, v: dict) -> dict:
        return {
            "u": self._project_field(v["u"]),
            "theta": self._project_field(v["theta"]) if v["theta"].size else v["theta"],
        }

    def project(self, v: dict) -> dict:
        """Public projection (the reference's proj_alpha)."""
        return self._proj(v)

    def matvec(self, v: dict) -> dict:
        return self._proj(self.exptA.matvec(self._proj(v)))

    def rmatvec(self, v: dict) -> dict:
        return self._proj(self.exptA.rmatvec(self._proj(v)))
