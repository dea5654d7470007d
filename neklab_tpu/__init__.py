"""neklab_tpu: JAX linear stability analysis for incompressible flows.

A from-scratch JAX/XLA framework with the capabilities of nekStab/neklab:
matrix-free exponential-propagator matvecs by time-stepping the linearized
(and exact-discrete-adjoint) Navier-Stokes equations on spectral-element
tensor-product kernels, Krylov-Schur/Arnoldi eigensolvers, Lanczos SVD
transient growth, GMRES resolvent analysis, Newton-Krylov base flows and
periodic orbits (Floquet), and OTD mode evolution — elements sharded across
devices, Krylov reductions as psums.

This facade mirrors /root/reference/src/neklab.f90 (`use neklab` re-exports
the LightKrylov algorithms plus every neklab type and driver).
"""

# Krylov layer (the LightKrylov surface: neklab.f90:28-42)
from .krylov import (
    AdjointOperator,
    EigsResult,
    FunctionOperator,
    GmresResult,
    KrylovBasis,
    LinearOperator,
    NewtonResult,
    NonlinearSystem,
    SvdsResult,
    VectorSpace,
    cg,
    constant_tol,
    dynamic_tol,
    eigs,
    euclidean_space,
    fgmres,
    gmres,
    newton,
    svds,
)

# meshes
from .mesh.box import box_mesh
from .mesh.core import SemMesh, build_mesh
from .mesh.cylinder import annulus_mesh

# solvers / models
from .models.navier_stokes import FlowConfig, FlowState, advance, initial_state, step
from .models.linearized import (
    LinConfig,
    PertState,
    make_adjoint_propagator,
    pert_initial,
    propagate,
    propagate_forced,
    step_lin,
)
from .models.precond import build_e_preconditioner

# vectors (neklab_vectors equivalents)
from .vectors import (
    ext_flow_vector,
    ext_flow_vector_space,
    flow_vector,
    flow_vector_space,
    get_size,
    project_c0,
)

# linear operators (neklab linops)
from .linops.exponential_propagator import ExponentialPropagator
from .linops.projected import ProjectedPropagator
from .linops.resolvent import Resolvent, complex_pair_space

# systems (neklab systems)
from .systems.fixed_point import FixedPointSystem
from .systems.periodic_orbit import MonodromyOperator, PeriodicOrbitSystem

# OTD
from .otd import OtdOpts, OtdResult, otd_analysis, otd_chunk

# analysis drivers (neklab_analysis)
from .analysis import (
    NewtonFPResult,
    StabilityResult,
    TransientGrowthResult,
    linear_stability_analysis_fixed_point,
    newton_fixed_point_iteration,
    transient_growth_analysis_fixed_point,
)

# utilities
from .utils.orr_sommerfeld import orr_sommerfeld_spectrum, shear_mode_eigenvalues
from .utils.parfile import ParCase, load_par
from .utils.timers import timer
from .utils.timestep import cfl_dt, horizon_steps

__version__ = "0.1.0"
