from .camera import Camera, get_rays, normalize_pixel_coords, pixel_grid_rays
from .emitters import EmitterTable, build_emitter_table
from .materials import MaterialTable, air, gather_rows, make_material_table
from .procedural import (
    analytic_sphere_scene,
    cornell_scene,
    cutout_chunk_scene,
    cutout_terrain_grid,
    emissive_room_scene,
    minecraft_chunk_scene,
    octree_from_grid,
    plant_scene,
    scattered_lights_scene,
    sphere_scene,
    terrain_grid,
)
from .scene import MAX_DIST, EmitterSampling, Scene, face_normals, make_scene
from .sun import Sun, SunSampling, make_sun, sky_color

__all__ = [
    "Camera",
    "EmitterTable",
    "build_emitter_table",
    "get_rays",
    "normalize_pixel_coords",
    "pixel_grid_rays",
    "MaterialTable",
    "air",
    "gather_rows",
    "make_material_table",
    "analytic_sphere_scene",
    "cornell_scene",
    "cutout_chunk_scene",
    "cutout_terrain_grid",
    "emissive_room_scene",
    "minecraft_chunk_scene",
    "octree_from_grid",
    "plant_scene",
    "scattered_lights_scene",
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
