"""Abstract distributed vector space over JAX pytrees + stacked Krylov basis.

The Krylov algorithms (eigs/svds/gmres/newton) see vectors only through this
interface — dot, axpby, scale, rand — exactly the layering the reference
inherits from LightKrylov's `abstract_vector_rdp` (SURVEY section 5,
"communication backend": algorithms are communication-agnostic; all
collectives live inside the operator and the dot).

A vector is any pytree of arrays. The inner product is supplied by the
application layer (e.g. the mass-weighted SEM dot that ignores pressure and
history slots, mirroring /root/reference/src/vectors/real_vectors.f90:208-233)
and must itself contain whatever `psum` the sharding needs.

A Krylov basis is stored as ONE stacked pytree (leading axis kmax) so that
CGS2 orthogonalization is two batched Gram matvecs per step — single jitted
calls — instead of O(k) scalar dot kernels per iteration. The basis
contractions state precision="highest": an f32 contraction left at the
default may run in TF32 on the H100, and the orthogonality lost there would
corrupt every Ritz value.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import jax
import numpy as np
import jax.numpy as jnp

Vector = Any


def tree_axpby(a, x: Vector, b, y: Vector) -> Vector:
    return jax.tree_util.tree_map(lambda xi, yi: a * xi + b * yi, x, y)


def tree_scale(a, x: Vector) -> Vector:
    return jax.tree_util.tree_map(lambda xi: a * xi, x)


def tree_add(x: Vector, y: Vector) -> Vector:
    return jax.tree_util.tree_map(jnp.add, x, y)


def tree_sub(x: Vector, y: Vector) -> Vector:
    return jax.tree_util.tree_map(jnp.subtract, x, y)


def tree_zeros_like(x: Vector) -> Vector:
    return jax.tree_util.tree_map(jnp.zeros_like, x)


@dataclasses.dataclass
class VectorSpace:
    """Bundle of the space-defining callables.

    dot_fn: (x, y) -> jnp scalar (must psum under SPMD; semi-inner products
            allowed — leaves not participating in dot still flow linearly
            through axpby, like the reference's lagged-history slots).
    rand_fn: (key) -> random vector in the admissible set (e.g. C0-continuous,
            BC-masked — real_vectors.f90:99-114 semantics).
    """

    dot_fn: Callable[[Vector, Vector], jnp.ndarray]
    rand_fn: Callable[[jax.Array], Vector] | None = None

    def __post_init__(self):
        self._jit_dot = jax.jit(self.dot_fn)
        self._vdot = jax.jit(jax.vmap(self.dot_fn, in_axes=(0, None)))

        def _ortho_pass(stack, w, mask):
            h = self._vdot_raw(stack, w) * mask
            w = jax.tree_util.tree_map(
                lambda s, wi: wi - jnp.tensordot(h, s, axes=(0, 0), precision="highest"), stack, w
            )
            return w, h

        def _ortho2(stack, w, k):
            kmax = _leading_dim(stack)
            mask = (jnp.arange(kmax) < k).astype(_dot_dtype(w))
            w, h1 = _ortho_pass(stack, w, mask)
            w, h2 = _ortho_pass(stack, w, mask)
            return w, h1 + h2

        def _ortho1(stack, w, k):
            kmax = _leading_dim(stack)
            mask = (jnp.arange(kmax) < k).astype(_dot_dtype(w))
            return _ortho_pass(stack, w, mask)

        self._vdot_raw = jax.vmap(self.dot_fn, in_axes=(0, None))
        self._jit_ortho2 = jax.jit(_ortho2)
        self._jit_ortho1 = jax.jit(_ortho1)
        self._jit_set = jax.jit(
            lambda stack, k, w: jax.tree_util.tree_map(lambda s, wi: s.at[k].set(wi), stack, w)
        )
        self._jit_get = jax.jit(lambda stack, k: jax.tree_util.tree_map(lambda s: s[k], stack))
        self._jit_lincomb = jax.jit(
            lambda stack, c: jax.tree_util.tree_map(
                lambda s: jnp.tensordot(c, s, axes=(0, 0), precision="highest"), stack)
        )

    def dot(self, x: Vector, y: Vector) -> float:
        return float(self._jit_dot(x, y))

    def norm(self, x: Vector) -> float:
        return float(np.sqrt(max(self.dot(x, x), 0.0)))

    def rand(self, key) -> Vector:
        if self.rand_fn is None:
            raise ValueError("VectorSpace has no rand_fn")
        return self.rand_fn(key)

    def normalize(self, w: Vector) -> tuple[Vector, float]:
        nrm = self.norm(w)
        if nrm > 0:
            w = tree_scale(1.0 / nrm, w)
        return w, nrm


def _leading_dim(stack) -> int:
    return jax.tree_util.tree_leaves(stack)[0].shape[0]


def _dot_dtype(w) -> jnp.dtype:
    return jax.tree_util.tree_leaves(w)[0].dtype


class KrylovBasis:
    """Preallocated orthonormal basis buffer of capacity kmax.

    Device-side stacked storage; `k` (the number of filled slots) is host
    state. Unfilled slots are zeros, so masked Gram contractions are exact.
    """

    def __init__(self, space: VectorSpace, template: Vector, kmax: int, _stack=None, _k=0):
        self.space = space
        self.kmax = kmax
        self.k = _k
        if _stack is not None:
            self.stack = _stack
        else:
            self.stack = jax.tree_util.tree_map(
                lambda l: jnp.zeros((kmax,) + l.shape, l.dtype), template
            )

    def append(self, w: Vector) -> None:
        if self.k >= self.kmax:
            raise IndexError("KrylovBasis full")
        self.stack = self.space._jit_set(self.stack, self.k, w)
        self.k += 1

    def __len__(self) -> int:
        return self.k

    def __getitem__(self, j: int) -> Vector:
        if not -self.k <= j < self.k:
            raise IndexError(j)
        return self.space._jit_get(self.stack, j % self.k)

    def vectors(self) -> list[Vector]:
        return [self[j] for j in range(self.k)]

    def orthogonalize(self, w: Vector, passes: int = 2) -> tuple[Vector, np.ndarray]:
        """CGS against the filled slots (CGS2 by default). Returns
        (w_orth, h[:k]) with h the summed projection coefficients."""
        fn = self.space._jit_ortho2 if passes == 2 else self.space._jit_ortho1
        w, h = fn(self.stack, w, self.k)
        return w, np.asarray(h)[: self.k]

    def lincomb(self, coeffs: np.ndarray) -> Vector:
        """sum_j coeffs[j] V_j (coeffs len k; may be complex).

        Complex coefficients are handled as two REAL device lincombs over the
        (real) basis, combined host-side into complex numpy leaves (a choice
        made for an accelerator without a complex dtype, kept because complex
        eigenvectors are terminal outputs: outposting and diagnostics).
        """
        if np.iscomplexobj(coeffs):
            vr = self.lincomb(np.ascontiguousarray(coeffs.real))
            vi = self.lincomb(np.ascontiguousarray(coeffs.imag))
            return jax.tree_util.tree_map(
                lambda re, im: np.asarray(re) + 1j * np.asarray(im), vr, vi
            )
        c = np.zeros(self.kmax, dtype=np.result_type(coeffs.dtype, np.float64))
        c[: self.k] = coeffs
        return self.space._jit_lincomb(self.stack, jnp.asarray(c))

    def lincomb_many(self, coeffs: np.ndarray) -> list[Vector]:
        """Columns: out[i] = sum_j coeffs[j, i] V_j."""
        return [self.lincomb(coeffs[:, i]) for i in range(coeffs.shape[1])]

    def rotated(self, coeffs: np.ndarray) -> "KrylovBasis":
        """New basis whose first p slots are V @ coeffs (coeffs [k, p] real)."""
        k, p = coeffs.shape
        assert k == self.k
        c = jnp.asarray(
            np.concatenate([coeffs, np.zeros((self.kmax - k, p))], axis=0)
        )
        new_stack = jax.tree_util.tree_map(
            lambda s: jnp.concatenate(
                [
                    jnp.tensordot(c, s, axes=(0, 0), precision="highest"),
                    jnp.zeros((self.kmax - p,) + s.shape[1:], s.dtype),
                ],
                axis=0,
            ),
            self.stack,
        )
        return KrylovBasis(self.space, None, self.kmax, _stack=new_stack, _k=p)


def euclidean_space(rand_template: Vector | None = None) -> VectorSpace:
    """Plain Euclidean dot over all leaves — used by the dense unit tests."""

    def dot_fn(x, y):
        leaves_x = jax.tree_util.tree_leaves(x)
        leaves_y = jax.tree_util.tree_leaves(y)
        return sum(jnp.sum(a * b) for a, b in zip(leaves_x, leaves_y))

    rand_fn = None
    if rand_template is not None:

        def rand_fn(key):
            leaves, treedef = jax.tree_util.tree_flatten(rand_template)
            keys = jax.random.split(key, len(leaves))
            new = [jax.random.normal(k, l.shape, l.dtype) for k, l in zip(keys, leaves)]
            return jax.tree_util.tree_unflatten(treedef, new)

    return VectorSpace(dot_fn=dot_fn, rand_fn=rand_fn)
