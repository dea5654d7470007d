"""Measurement machinery: compile-cache location, peak table, device guard,
and the contraction precision the Krylov layer states."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bench
from neklab_tpu.krylov.space import KrylovBasis, euclidean_space
from neklab_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


@pytest.mark.parametrize("env", ["set", "unset"])
def test_compile_cache_dir(env, monkeypatch, tmp_path, restore_cache_dir):
    jax.config.update("jax_compilation_cache_dir", None)
    if env == "set":
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        # JAX reads the variable itself; the helper sets nothing
        assert jax.config.jax_compilation_cache_dir is None
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path


@pytest.mark.parametrize("kind,known", [("NVIDIA H100 80GB HBM3", True),
                                        ("Tesla K80", False), ("cpu", False)])
def test_peak_table(kind, known):
    if known:
        peaks = bench.peaks_for(kind)
        assert peaks["hbm_bytes_per_s"] == 3.35e12
        assert peaks["bf16_tensor_flops"] > peaks["tf32_tensor_flops"] > peaks["fp32_flops"]
    else:
        with pytest.raises(ValueError, match="no published peak"):
            bench.peaks_for(kind)


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        bench.require_gpu()


def test_device_record_names_the_device():
    rec = bench.device_record()
    assert rec == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())}


def _precisions(txt):
    return re.findall(r"dot_general", txt), re.findall(r"precision = \[(\w+), (\w+)\]", txt)


def test_krylov_contractions_state_highest_precision():
    """An f32 contraction left at the default precision may run in TF32 on
    the GPU; every basis contraction of the CGS2 pass, the lincomb and the
    rotation must ask for HIGHEST."""
    space = euclidean_space()
    stack = {"u": jnp.zeros((5, 3, 4), jnp.float32)}
    w = {"u": jnp.ones((3, 4), jnp.float32)}
    coeffs = jnp.ones(5, jnp.float32)
    programs = {
        "cgs2": space._jit_ortho2.lower(stack, w, 2).as_text(),
        "lincomb": space._jit_lincomb.lower(stack, coeffs).as_text(),
        "rotated": str(jax.make_jaxpr(
            lambda s: KrylovBasis(space, None, 5, _stack=s, _k=2).rotated(
                np.ones((2, 1), np.float32)).stack)(stack)),
    }
    dots, precs = _precisions(programs["cgs2"])
    assert len(dots) == 2 and precs == [("HIGHEST", "HIGHEST")] * 2
    dots, precs = _precisions(programs["lincomb"])
    assert len(dots) == 1 and precs == [("HIGHEST", "HIGHEST")]
    assert "precision=(Precision.HIGHEST, Precision.HIGHEST)" in programs["rotated"]
