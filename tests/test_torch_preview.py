"""The flat-shaded preview (kernel K10's twin after the walk) against the
JAX package's ``preview_image``: the sphere at ``test_preview.py``'s size
(depth 4, 24x18), the cutout terrain (K2's alpha accept, depth 4, 16x16)
and the plant field (K2q's quad models, depth 3, 16x12), each scene and
camera carried over from the JAX package as numpy arrays.  Per pixel within
rtol 1e-4 / atol 1e-5 (the gate of test_preview.py), at most 2 pixels
beyond it on a knife-edge hit.  Also ``flat_shading`` alone, the twin's
refusal of a quad-model walk without its quad surfaces, and ``cli preview
--device cpu`` writing an image.  The JAX references are computed once for
the module."""

import numpy as np
import pytest
import torch

from octree_pathtracing_tpu.models import cutout_chunk_scene as jax_cutout_scene
from octree_pathtracing_tpu.models import plant_scene as jax_plant_scene
from octree_pathtracing_tpu.models import sphere_scene as jax_sphere_scene
from octree_pathtracing_tpu.models.sun import flat_shading as jax_flat_shading
from octree_pathtracing_tpu.render.preview import preview_image as jax_preview_image
from octree_pathtracing_tpu_torch.cli import main
from octree_pathtracing_tpu_torch.models.camera import pixel_grid_rays
from octree_pathtracing_tpu_torch.models.convert import camera_from_numpy, scene_from_jax_arrays
from octree_pathtracing_tpu_torch.models.sun import flat_shading
from octree_pathtracing_tpu_torch.ops.preview import preview_shade, preview_shade_reference
from octree_pathtracing_tpu_torch.render.pathtracer import _trace
from octree_pathtracing_tpu_torch.render.preview import preview_image

CASES = {"sphere": (jax_sphere_scene, 4, 24, 18), "cutout": (jax_cutout_scene, 4, 16, 16),
         "plant": (jax_plant_scene, 3, 16, 12)}


def _camera(cam):
    return camera_from_numpy(np.asarray(cam.eye), np.asarray(cam.direction), np.asarray(cam.up), cam.fov,
                             cam.aperture, cam.focal_distance)


@pytest.fixture(scope="module")
def previews():
    """name -> (port scene, port camera, width, height, the JAX frame)."""
    out = {}
    for name, (build, depth, w, h) in CASES.items():
        jscene, jcam = build(depth=depth)
        out[name] = (scene_from_jax_arrays(jscene), _camera(jcam), w, h,
                     np.asarray(jax_preview_image(jscene, jcam, w, h)))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_preview_image_matches_jax(previews, name):
    scene, cam, w, h, want = previews[name]
    got = preview_image(scene, cam, w, h)
    assert got.shape == (h, w, 3) and got.dtype == torch.float32
    got = got.numpy()
    bad = ~np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert bad.sum() <= 2, (bad.sum(), np.argwhere(bad)[:5])
    assert np.isfinite(got).all() and got.std() > 0.01  # hits and sky both in frame


@pytest.mark.parametrize("name", list(CASES))
def test_preview_shade_is_its_twin_on_the_cpu(previews, name):
    """On CPU tensors the wrapper runs the plain version and counts no
    launch."""
    scene, cam, w, h, _ = previews[name]
    o, d = pixel_grid_rays(cam, w, h)
    res = _trace(scene, o, d)
    before = preview_shade.launches
    assert torch.equal(preview_shade(scene, d, res), preview_shade_reference(scene, d, res))
    assert preview_shade.launches == before


def test_flat_shading_matches_jax(previews):
    scene = previews["sphere"][0]
    rng = np.random.default_rng(3)
    n = rng.standard_normal((64, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    c = rng.random((64, 3), dtype=np.float32)
    jscene, _ = jax_sphere_scene(depth=2)
    want = np.asarray(jax_flat_shading(jscene.sun, n, c))
    np.testing.assert_allclose(flat_shading(scene.sun, torch.from_numpy(n), torch.from_numpy(c)).numpy(), want,
                               rtol=1e-6, atol=1e-7)


def test_preview_refuses_a_quad_walk_without_its_surfaces(previews):
    scene, cam, w, h, _ = previews["plant"]
    o, d = pixel_grid_rays(cam, w, h)
    res = _trace(scene, o, d)._replace(quad=None)
    with pytest.raises(ValueError, match="quad"):
        preview_shade(scene, d, res)


def test_cli_preview_writes_an_image(tmp_path, capsys):
    out = tmp_path / "p.ppm"
    main(["preview", "--scene", "sphere", "--depth", "4", "--width", "24", "--height", "18", "--device", "cpu",
          "-o", str(out)])
    assert "on cpu" in capsys.readouterr().out
    data = out.read_bytes()
    header = b"P6\n24 18\n255\n"
    assert data.startswith(header) and len(data) == len(header) + 24 * 18 * 3
