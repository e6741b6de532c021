"""What the GPU bring-up relies on, checked on the CPU: full-precision
products on the render path, the compile-cache helper, the smoke script's
device check and the native builder's rebuild.  Tests marked ``gpu`` run
only where JAX finds a GPU (see the README)."""

import logging
import os
import re
import shutil
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import spira_tpu as st

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _f32_dot_precisions(lowered_text):
    """Precision attributes of every float32 dot_general in StableHLO."""
    out = []
    for line in lowered_text.splitlines():
        if "stablehlo.dot_general" in line and "xf32>" in line:
            m = re.search(r"precision = \[(\w+), (\w+)\]", line)
            out.append(m.groups() if m else ("DEFAULT", "DEFAULT"))
    return out


def _lower_wavefront(spectral):
    from spira_tpu.render import render_flat

    scene = st.create_cornell_box()
    cam = st.cornell_camera(1.0)
    return render_flat.lower(scene, cam, width=8, height=4, spp=1,
                             max_depth=2, spectral=spectral).as_text()


def _lower_fused_spectral():
    from spira_tpu.kernels.spectral_fused import _fused_spectral_xla

    scene = st.create_scene()
    return _fused_spectral_xla.lower(
        jnp.int32(0), scene, st.default_camera(2.0), width=8, height=4,
        spp=1, max_depth=2, n_spheres=scene.spheres.count, n_tris=0,
        inclusive_uv=True,
    ).as_text()


def _lower_row_set():
    from spira_tpu.core import rng as srng
    from spira_tpu.render import accumulate_row_set

    return accumulate_row_set.lower(
        st.create_scene(), st.default_camera(2.0), srng.base_key(0),
        jnp.arange(2, dtype=jnp.int32), jnp.int32(0), width=8, height=4,
        n_samples=1, max_depth=2,
    ).as_text()


@pytest.mark.parametrize("render", [
    "wavefront_rgb", "wavefront_spectral", "fused_spectral", "adaptive_rows",
])
def test_render_products_ask_for_highest_precision(render):
    """A GPU runs a float32 product in TF32 (~3 digits) unless HIGHEST is
    asked for; the one-hot row selections of the wavefront would then
    round sphere centres, normals and materials.  The lowering shows the
    request on any backend."""
    text = {
        "wavefront_rgb": lambda: _lower_wavefront(False),
        "wavefront_spectral": lambda: _lower_wavefront(True),
        "fused_spectral": _lower_fused_spectral,
        "adaptive_rows": _lower_row_set,
    }[render]()
    precisions = _f32_dot_precisions(text)
    assert precisions, "expected float32 products on this path"
    assert all(p == ("HIGHEST", "HIGHEST") for p in precisions), precisions


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(monkeypatch, env_set):
    """JAX_COMPILATION_CACHE_DIR wins and is left to JAX; without it the
    cache sits at a fixed path inside the checkout."""
    from spira_tpu.utils import cache

    seen = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: seen.append((name, value)))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
        assert cache.enable_compile_cache() == "/elsewhere/cache"
        assert seen == []
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = cache.enable_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert path == cache.enable_compile_cache()  # stable across calls
        assert seen == [("jax_compilation_cache_dir", path)] * 2


def test_chip_smoke_refuses_a_cpu_backend():
    """The smoke script measures the card only: on the CPU it exits
    non-zero before printing any result."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu()
    assert exc.value.code not in (0, None)
    assert "no GPU" in str(exc.value.code)


def _fresh_native(monkeypatch, tmp_path):
    from spira_tpu.accel import native

    src = os.path.join(ROOT, "native")
    dst = tmp_path / "native"
    dst.mkdir()
    for name in ("Makefile", "bvh_builder.cpp", "obj_loader.cpp"):
        shutil.copy(os.path.join(src, name), dst / name)
    monkeypatch.setattr(native, "_NATIVE_DIR", str(dst))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_tried", False)
    return native, dst


def test_native_loader_rebuilds_a_stale_library(monkeypatch, tmp_path):
    """A library older than its sources (say, built elsewhere) is rebuilt
    from the committed sources before it is loaded."""
    native, dst = _fresh_native(monkeypatch, tmp_path)
    lib = dst / "libspira_native.so"
    lib.write_bytes(b"not a library")
    old = time.time() - 3600
    os.utime(lib, (old, old))
    assert native._stale(str(lib))
    assert native._load_library() is not None
    assert not native._stale(str(lib))
    assert lib.stat().st_size > 1000

    lo = np.random.default_rng(0).uniform(-1, 0, (64, 3)).astype(np.float32)
    bvh = native.build_bvh_best(lo, lo + 0.1)
    assert native.last_builder() == "native-sah"
    assert int(bvh.node_count) > 1


def test_native_build_failure_warns_and_falls_back(monkeypatch, tmp_path,
                                                   caplog):
    native, dst = _fresh_native(monkeypatch, tmp_path)
    (dst / "bvh_builder.cpp").write_text("this is not C++\n")
    with caplog.at_level(logging.WARNING, logger="spira_tpu"):
        assert native._load_library() is None
    assert any("native build failed" in r.message for r in caplog.records)
    lo = np.random.default_rng(0).uniform(-1, 0, (64, 3)).astype(np.float32)
    native.build_bvh_best(lo, lo + 0.1)
    assert native.last_builder() == "numpy-median"


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided here, at run
    time, never at import)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX found {dev.platform!r}")
    return dev


@pytest.mark.gpu
def test_triton_kernel_compiles_and_matches_fused_on_gpu(gpu):
    from spira_tpu.kernels.megakernel import (
        render_flat_fused,
        render_flat_megakernel,
    )

    scene = st.create_scene()
    cam = st.default_camera(2.0)
    kw = dict(width=96, height=48, spp=4, max_depth=4, seed=2)
    got = np.asarray(render_flat_megakernel(scene, cam, **kw))
    want = np.asarray(render_flat_fused(scene, cam, **kw))
    d = np.abs(got - want).max(axis=-1)
    assert d.mean() <= 1e-4 and (d <= 1e-3).mean() >= 0.995
