"""End-to-end stability-analysis integration tests (the minimum slice of
SURVEY section 7): eigenvalues of the SEM exponential propagator for plane
Poiseuille flow vs. an independent Chebyshev Orr-Sommerfeld oracle.

This is the analog of the reference's CylEigsDir integration test
(test/neklabTests.py:16-47) at a tractable size, with the oracle computed
from scratch instead of hard-coded."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from neklab_tpu.analysis import (
    linear_stability_analysis_fixed_point,
    transient_growth_analysis_fixed_point,
)
from neklab_tpu.krylov.space import tree_axpby
from neklab_tpu.linops.exponential_propagator import ExponentialPropagator
from neklab_tpu.mesh.box import box_mesh
from neklab_tpu.models.linearized import LinConfig
from neklab_tpu.models.navier_stokes import FlowConfig
from neklab_tpu.utils.orr_sommerfeld import (
    orr_sommerfeld_spectrum,
    shear_mode_eigenvalues,
)
from neklab_tpu.vectors import flow_vector_space

RE = 500.0


def test_os_oracle_literature():
    # classical Re = 10000, alpha = 1 value (Orszag 1971)
    lam = orr_sommerfeld_spectrum(10000, 1.0, 128)[0]
    assert abs(lam.real - 0.00373967) < 1e-7
    assert abs(abs(lam.imag) - 0.23752649) < 1e-7


@pytest.fixture(scope="module")
def poiseuille():
    mesh = box_mesh(
        (4, 5), ((0, 2 * np.pi), (-1, 1)), {"x-": "P", "x+": "P", "y-": "W", "y+": "W"}, order=6
    )
    cfg = LinConfig(flow=FlowConfig(viscosity=1 / RE, dt=1e-2, vtol=1e-12, ptol=1e-12))
    y = mesh.x[1]
    U = jnp.stack([1 - y**2, 0 * y])
    expA = ExponentialPropagator(mesh, cfg, U, tau=0.5, cfl=0.5)
    space = flow_vector_space(mesh, 0)
    return mesh, expA, space


def _oracle(re):
    cand = list(shear_mode_eigenvalues(re, 6).astype(complex))
    for a in (1.0, 2.0):
        lam = orr_sommerfeld_spectrum(re, a, 96)[:6]
        cand.extend(lam)
        cand.extend(np.conj(lam))
    return np.array(cand)


@pytest.mark.slow
def test_poiseuille_eigenvalues(poiseuille):
    mesh, expA, space = poiseuille
    res = linear_stability_analysis_fixed_point(
        expA, space, kdim=40, nev=4, tol=2e-6, maxiter=12
    )
    assert res.residuals.max() < 2e-6
    cand = _oracle(RE)
    for lam in res.eigvals:
        dist = np.min(np.abs(cand - lam))
        assert dist < 2e-4, (lam, dist)
    # leading mode is the analytic shear mode -nu (pi/2)^2 to tight tolerance
    assert abs(res.eigvals[0] - (-(1 / RE) * (np.pi / 2) ** 2)) < 1e-5


@pytest.mark.slow
def test_poiseuille_adjoint_spectrum(poiseuille):
    # the adjoint operator has the same spectrum (neklab runs dir + adj pairs)
    mesh, expA, space = poiseuille
    res = linear_stability_analysis_fixed_point(
        expA, space, kdim=30, nev=2, tol=1e-5, maxiter=12, adjoint=True
    )
    lam1 = -(1 / RE) * (np.pi / 2) ** 2
    lam2 = -(1 / RE) * np.pi**2
    assert abs(res.eigvals[0] - lam1) < 1e-4
    assert abs(res.eigvals[1] - lam2) < 1e-4


def test_transient_growth(poiseuille):
    mesh, expA, space = poiseuille
    res = transient_growth_analysis_fixed_point(expA, space, kdim=12, nsv=2, tol=1e-7)
    # sigma_1 >= |mu_1| = e^{lambda_1 tau} (operator norm bounds spectral radius)
    mu1 = np.exp(-(1 / RE) * (np.pi / 2) ** 2 * expA.tau)
    assert res.sigma[0] >= mu1 - 1e-8
    # non-normal growth: strictly above the spectral bound for shear flow
    assert res.sigma[0] > mu1 * 1.001
    # triplet identity: M v1 = sigma1 u1
    v1 = res.optimal_inputs[0]
    u1 = res.optimal_outputs[0]
    mv = expA.matvec(v1)
    diff = tree_axpby(1.0, mv, -float(res.sigma[0]), u1)
    num = np.sqrt(space.dot(diff, diff))
    assert num < 1e-5 * res.sigma[0]


def test_projected_propagator_alpha1(poiseuille):
    # exptA_proj: restricting to the alpha=1 Fourier mode must yield the OS
    # alpha=1 branch (reference examples/poiseuille/stability/direct_alpha_1)
    from neklab_tpu.linops.projected import ProjectedPropagator

    mesh, expA, space = poiseuille
    proj = ProjectedPropagator(expA, alpha=1.0)
    res = linear_stability_analysis_fixed_point(
        proj, space, kdim=30, nev=2, tol=1e-7, maxiter=10
    )
    lam = res.eigvals[0]
    oracle = orr_sommerfeld_spectrum(RE, 1.0, 96)[0]
    assert abs(lam.real - oracle.real) < 2e-4
    assert abs(abs(lam.imag) - abs(oracle.imag)) < 2e-4
    # the alpha=0 shear modes (leading unprojected) must be absent
    assert abs(lam.real - (-(1 / RE) * (np.pi / 2) ** 2)) > 1e-2


def test_chunked_propagator_matches_and_adjoint_identity():
    """propagate_chunked == propagate exactly (same step composition), and
    its chain-transposed adjoint satisfies <Mu, v>_B = <u, M*v>_B — the
    bounded-compile path for long horizons (the BFS tau=18 adjoint at 2611
    steps crashed an earlier compiler as ONE program; chunks are the fix)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from neklab_tpu.mesh.box import box_mesh
    from neklab_tpu.models.linearized import (
        LinConfig, make_adjoint_propagator_chunked, propagate, propagate_chunked,
    )
    from neklab_tpu.models.navier_stokes import FlowConfig
    from neklab_tpu.ops import sem

    mesh = box_mesh((4, 3), ((0, 2 * np.pi), (-1, 1)),
                    {"x-": "P", "x+": "P", "y-": "W", "y+": "W"}, order=4)
    fc = FlowConfig(viscosity=1e-2, dt=2e-2, vtol=1e-12, ptol=1e-11)
    cfg = LinConfig(flow=fc)
    y = mesh.x[1]
    base_u = jnp.stack([1 - y**2, 0 * y])
    th = jnp.zeros((0,) + mesh.bm1.shape)
    key = jax.random.PRNGKey(0)
    # the B-adjoint identity <Mu, v>_B = <u, M*v>_B holds on the CONFORMING
    # (C0-continuous, masked) subspace the operator acts on — dsavg-project
    # the raw random fields onto it (vmask*noise alone is multi-valued on
    # shared faces and the identity degrades to O(1e-2))
    u0 = mesh.vmask * sem.dsavg(mesh, mesh.vmask * jax.random.normal(key, (2,) + mesh.bm1.shape))
    v0 = mesh.vmask * sem.dsavg(mesh, mesh.vmask * jax.random.normal(jax.random.PRNGKey(1), (2,) + mesh.bm1.shape))

    nsteps = 11
    ref_u, _ = propagate(mesh, cfg, base_u, th, u0, th, nsteps)
    chk_u, _ = propagate_chunked(mesh, cfg, base_u, th, u0, th, nsteps, chunk=4)
    assert np.abs(np.asarray(ref_u) - np.asarray(chk_u)).max() < 1e-13

    adj = make_adjoint_propagator_chunked(mesh, cfg, base_u, th, nsteps, chunk=4)
    wu, _ = adj(v0, th)
    lhs = float(sem.mass_dot(mesh, ref_u, v0))
    rhs = float(sem.mass_dot(mesh, u0, wu))
    assert abs(lhs - rhs) < 1e-9 * max(abs(lhs), 1.0), (lhs, rhs)
