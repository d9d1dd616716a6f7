"""Shading-layer parity: the port's texture, material, sun, camera, BRDF
sampling and hit-resolution functions against the JAX package's on the same
seeded inputs.

Tolerance rtol 1e-5 / atol 1e-6: XLA and torch may round sin, cos, sqrt and
pow an ulp apart, and nothing here accumulates more than a few such steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octree_pathtracing_tpu.models import camera as jcam
from octree_pathtracing_tpu.models import materials as jmat
from octree_pathtracing_tpu.models import minecraft_chunk_scene as jax_chunk_scene
from octree_pathtracing_tpu.models import sun as jsun
from octree_pathtracing_tpu.ops import shading as jsh
from octree_pathtracing_tpu.ops import texture as jtex
from octree_pathtracing_tpu.ops.traversal import HitResult as JHitResult
from octree_pathtracing_tpu.render import hit as jhit
from octree_pathtracing_tpu.render import pathtracer as jpt
from octree_pathtracing_tpu_torch.models import camera as tcam
from octree_pathtracing_tpu_torch.models import materials as tmat
from octree_pathtracing_tpu_torch.models import sun as tsun
from octree_pathtracing_tpu_torch.models.convert import scene_from_jax_arrays
from octree_pathtracing_tpu_torch.ops import shading as tsh
from octree_pathtracing_tpu_torch.ops import texture as ttex
from octree_pathtracing_tpu_torch.ops.traversal import HitResult as THitResult
from octree_pathtracing_tpu_torch.render import hit as thit
from octree_pathtracing_tpu_torch.render import pathtracer as tpt

B = 512
RTOL, ATOL = 1e-5, 1e-6


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def both(x):
    """numpy -> (jax array, torch tensor) of the same values."""
    x = np.ascontiguousarray(x)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(scope="module")
def scenes():
    jscene, _ = jax_chunk_scene(depth=3)
    return jscene, scene_from_jax_arrays(jscene)


def _images(rng):
    return [
        rng.integers(0, 256, (16, 16, 4), dtype=np.uint8),
        rng.integers(0, 256, (8, 32, 4), dtype=np.uint8),
        rng.integers(0, 256, (5, 7, 3), dtype=np.uint8),
    ]


@pytest.mark.parametrize("size", [16, None])
def test_build_and_sample_atlas(rng, size):
    images = _images(rng)
    ja = jtex.build_atlas(images, size=size)
    ta = ttex.build_atlas(images, size=size)
    if size is None:
        close(ta.data, ja.data, 0, 0)
        np.testing.assert_array_equal(ta.sizes.numpy(), np.asarray(ja.sizes))
    else:
        close(ta, ja, 0, 0)
    layer = rng.integers(0, 3, B).astype(np.int32)
    uv = rng.uniform(-0.1, 1.1, (B, 2)).astype(np.float32)
    jl, tl = both(layer)
    ju, tu = both(uv)
    close(ttex.sample_atlas(ta, tl, tu[:, 0], tu[:, 1]), jtex.sample_atlas(ja, jl, ju[:, 0], ju[:, 1]), 0, 0)


def test_gamma_and_u8(rng):
    x = rng.uniform(-0.2, 1.5, (64, 3)).astype(np.float32)
    jx, tx = both(x)
    close(ttex.srgb_to_linear(tx), jtex.srgb_to_linear(jx))
    np.testing.assert_array_equal(ttex.float_to_u8(x), jtex.float_to_u8(x))


def test_material_table_and_gather_rows(rng):
    rows = [jmat.air(), dict(texture_index=1, emittance=3.0), dict(ior=1.33, specular=0.2, flags=5),
            dict(metalness=0.7, roughness=0.3, texture_index=2)]
    jm = jmat.make_material_table(rows)
    tm = tmat.make_material_table(rows)
    mat = rng.integers(0, 4, B).astype(np.int32)
    jr = jmat.gather_rows(jm, jnp.asarray(mat))
    tr = tmat.gather_rows(tm, torch.from_numpy(mat))
    for k in jr:
        close(tr[k], np.asarray(jr[k]).astype(np.float64), 0, 0)


def test_sun_tables_and_sky(rng, scenes):
    js, ts = jsun.make_sun(), tsun.make_sun()
    for f in ("sw", "su", "sv", "emittance", "radius_cos", "altitude", "apparent_texture_brightness"):
        close(getattr(ts, f), getattr(js, f), 0, 0)
    # half the directions near the sun so the disk window is exercised
    d = unit(rng, B)
    near = np.asarray(js.sw)[None, :] + rng.normal(0, 0.05, (B // 2, 3))
    d[: B // 2] = near / np.linalg.norm(near, axis=-1, keepdims=True)
    jd, td = both(d.astype(np.float32))
    color = rng.uniform(0, 1, (B, 4)).astype(np.float32)
    jc, tc = both(color)
    in_disk = np.asarray(jsun.sun_disk_factor(js, jd)[0])
    assert 0 < in_disk.sum() < B
    np.testing.assert_array_equal(tsun.sun_disk_factor(ts, td)[0].numpy(), in_disk)
    close(tsun.add_sun_color(ts, td, tc), jsun.add_sun_color(js, jd, jc))
    close(tsun.add_sun_color_diffuse(ts, td, tc), jsun.add_sun_color_diffuse(js, jd, jc))
    u1, u2 = rng.uniform(0, 1, (2, B)).astype(np.float32)
    close(tsun.random_sun_direction(ts, torch.from_numpy(u1), torch.from_numpy(u2)),
          jsun.random_sun_direction(js, jnp.asarray(u1), jnp.asarray(u2)))

    jscene, tscene = scenes
    b0 = rng.random(B) < 0.3
    spec = rng.random(B) < 0.5
    close(tpt.sky_radiance(tscene, td, torch.from_numpy(b0), torch.from_numpy(spec)),
          jpt.sky_radiance(jscene, jd, jnp.asarray(b0), jnp.asarray(spec)))


def _face_or_random_normals(rng):
    faces = np.asarray(jpt.face_normals())[rng.integers(0, 6, B // 2)]
    return np.concatenate([faces, unit(rng, B - B // 2)]).astype(np.float32)


def test_specular_and_refraction(rng):
    n = _face_or_random_normals(rng)
    d_in = unit(rng, B)
    rough = np.where(rng.random(B) < 0.3, 0.0, rng.uniform(0, 1, B)).astype(np.float32)
    u = rng.uniform(0, 1, (B, jsh.N_UNIFORMS)).astype(np.float32)
    (jn, tn), (jd, td), (jr, tr), (ju, tu) = both(n), both(d_in), both(rough), both(u)
    close(tsh.specular_reflect_dir(td, tn, tr, tu), jsh.specular_reflect_dir(jd, jn, jr, ju))

    ior1 = rng.choice([1.000293, 1.33, 1.5], B).astype(np.float32)
    ior2 = rng.choice([1.000293, 1.33, 1.5], B).astype(np.float32)
    (j1, t1), (j2, t2) = both(ior1), both(ior2)
    cos_t = -np.sum(d_in * n, axis=-1).astype(np.float32)
    ratio = (ior1 / ior2).astype(np.float32)
    radicand = (1.0 - ratio * ratio * (1.0 - cos_t * cos_t)).astype(np.float32)
    (jc, tc), (jq, tq), (jrad, trad) = both(cos_t), both(ratio), both(radicand)
    close(tsh.refract_dir(td, tn, tq, tc, trad), jsh.refract_dir(jd, jn, jq, jc, jrad))
    close(tsh.fresnel_schlick(t1, t2, tc), jsh.fresnel_schlick(j1, j2, jc))


@pytest.mark.parametrize("importance", [False, True])
def test_diffuse_dir_and_weight(rng, importance):
    n = _face_or_random_normals(rng)
    u = rng.uniform(0, 1, (B, jsh.N_UNIFORMS)).astype(np.float32)
    # many lanes take the sun cap: importance chance is 0.1
    u[: B // 4, jsh.U_IMPORTANCE] *= 0.1
    (jn, tn), (ju, tu) = both(n), both(u)
    jd, jw = jsh.diffuse_dir_and_weight(jn, jsun.make_sun(), ju, importance)
    td, tw = tsh.diffuse_dir_and_weight(tn, tsun.make_sun(), tu, importance)
    close(td, jd)
    close(tw, jw)


def test_pixel_grid_rays(rng):
    eye, center = (-12.8, 25.6, -12.8), (16.0, 9.6, 16.0)
    jc = jcam.Camera.look_at(eye=eye, center=center)
    tc = tcam.Camera.look_at(eye=eye, center=center)
    close(tc.direction, jc.direction)
    close(tc.up, jc.up)
    jitter = rng.uniform(-1 / 24, 1 / 24, (24 * 18, 2)).astype(np.float32)
    for jit in (None, jitter):
        jo, jd = jcam.pixel_grid_rays(jc, 24, 18, None if jit is None else jnp.asarray(jit))
        to, td = tcam.pixel_grid_rays(tc, 24, 18, None if jit is None else torch.from_numpy(jit))
        close(to, jo, 0, 0)
        close(td, jd)


def test_resolve_hit(rng, scenes):
    jscene, tscene = scenes
    hit = rng.random(B) < 0.7
    face = np.where(hit, rng.integers(0, 6, B), -1).astype(np.int32)
    leaf = np.where(hit, rng.integers(0, 6, B), 0).astype(np.int32)
    t = np.where(hit, rng.uniform(0, 40, B), np.inf).astype(np.float32)
    uv = rng.uniform(0, 1, (B, 2)).astype(np.float32)
    vpos = rng.uniform(0, 8, (B, 3)).astype(np.float32)
    vsize = np.ones(B, np.float32)
    o, d = rng.uniform(0, 8, (B, 3)).astype(np.float32), unit(rng, B)
    jres = JHitResult(*(jnp.asarray(x) for x in (hit, t, face, uv, leaf.astype(np.uint32), vpos, vsize)),
                      steps=jnp.int32(0))
    tres = THitResult(*(torch.from_numpy(x) for x in (hit, t, face, uv, leaf, vpos, vsize)),
                      fetches=torch.zeros(B, dtype=torch.int32))
    got = thit.resolve_hit(tscene, torch.from_numpy(o), torch.from_numpy(d), tres)
    want = jhit.resolve_hit(jscene, jnp.asarray(o), jnp.asarray(d), jres)
    for g, w in zip(got, want):
        close(g, w, 0, 0)
