from .camera import Camera, get_rays, normalize_pixel_coords, pixel_grid_rays
from .materials import MaterialTable, air, gather_rows, make_material_table
from .procedural import (
    cornell_scene,
    cutout_chunk_scene,
    cutout_terrain_grid,
    minecraft_chunk_scene,
    octree_from_grid,
    sphere_scene,
    terrain_grid,
)
from .scene import MAX_DIST, EmitterSampling, Scene, face_normals, make_scene
from .sun import Sun, SunSampling, make_sun, sky_color

__all__ = [
    "Camera",
    "get_rays",
    "normalize_pixel_coords",
    "pixel_grid_rays",
    "MaterialTable",
    "air",
    "gather_rows",
    "make_material_table",
    "cornell_scene",
    "cutout_chunk_scene",
    "cutout_terrain_grid",
    "minecraft_chunk_scene",
    "octree_from_grid",
    "sphere_scene",
    "terrain_grid",
    "MAX_DIST",
    "EmitterSampling",
    "Scene",
    "face_normals",
    "make_scene",
    "Sun",
    "SunSampling",
    "make_sun",
    "sky_color",
]
