"""Biome climate table + grass/foliage colormap sampling.

A copy of ``octree_pathtracing_tpu/models/biomes.py``.  Materials carry a
``tint_index``; a tinted face's color comes from the pack's
``textures/colormap/{grass,foliage}.png`` keyed by the biome's
(temperature, downfall) climate — the vanilla lookup:
``adj_t = clamp(t, 0, 1); adj_d = clamp(d, 0, 1) * adj_t;
x = (1 - adj_t) * 255; y = (1 - adj_d) * 255``.

Climate values are vanilla data (biome definition JSONs ship in the client
jar, not resource packs, so a small built-in table covers the overworld set;
unknown biomes fall back to plains).
"""

from __future__ import annotations

import numpy as np

# biome -> (temperature, downfall); vanilla overworld set
BIOME_CLIMATE: dict[str, tuple[float, float]] = {
    "minecraft:plains": (0.8, 0.4),
    "minecraft:sunflower_plains": (0.8, 0.4),
    "minecraft:forest": (0.7, 0.8),
    "minecraft:flower_forest": (0.7, 0.8),
    "minecraft:birch_forest": (0.6, 0.6),
    "minecraft:old_growth_birch_forest": (0.6, 0.6),
    "minecraft:dark_forest": (0.7, 0.8),
    "minecraft:jungle": (0.95, 0.9),
    "minecraft:sparse_jungle": (0.95, 0.8),
    "minecraft:bamboo_jungle": (0.95, 0.9),
    "minecraft:taiga": (0.25, 0.8),
    "minecraft:old_growth_pine_taiga": (0.3, 0.8),
    "minecraft:old_growth_spruce_taiga": (0.25, 0.8),
    "minecraft:snowy_taiga": (-0.5, 0.4),
    "minecraft:snowy_plains": (0.0, 0.5),
    "minecraft:ice_spikes": (0.0, 0.5),
    "minecraft:snowy_slopes": (-0.3, 0.9),
    "minecraft:grove": (-0.2, 0.8),
    "minecraft:jagged_peaks": (-0.7, 0.9),
    "minecraft:frozen_peaks": (-0.7, 0.9),
    "minecraft:stony_peaks": (1.0, 0.3),
    "minecraft:windswept_hills": (0.2, 0.3),
    "minecraft:windswept_gravelly_hills": (0.2, 0.3),
    "minecraft:windswept_forest": (0.2, 0.3),
    "minecraft:windswept_savanna": (2.0, 0.0),
    "minecraft:savanna": (2.0, 0.0),
    "minecraft:savanna_plateau": (2.0, 0.0),
    "minecraft:desert": (2.0, 0.0),
    "minecraft:badlands": (2.0, 0.0),
    "minecraft:eroded_badlands": (2.0, 0.0),
    "minecraft:wooded_badlands": (2.0, 0.0),
    "minecraft:swamp": (0.8, 0.9),
    "minecraft:mangrove_swamp": (0.8, 0.9),
    "minecraft:mushroom_fields": (0.9, 1.0),
    "minecraft:meadow": (0.5, 0.8),
    "minecraft:cherry_grove": (0.5, 0.8),
    "minecraft:river": (0.5, 0.5),
    "minecraft:frozen_river": (0.0, 0.5),
    "minecraft:beach": (0.8, 0.4),
    "minecraft:snowy_beach": (0.05, 0.3),
    "minecraft:stony_shore": (0.2, 0.3),
    "minecraft:ocean": (0.5, 0.5),
    "minecraft:deep_ocean": (0.5, 0.5),
    "minecraft:lukewarm_ocean": (0.5, 0.5),
    "minecraft:warm_ocean": (0.5, 0.5),
    "minecraft:cold_ocean": (0.5, 0.5),
    "minecraft:frozen_ocean": (0.0, 0.5),
    "minecraft:dripstone_caves": (0.8, 0.4),
    "minecraft:lush_caves": (0.5, 0.5),
    "minecraft:deep_dark": (0.8, 0.4),
}

_PLAINS = BIOME_CLIMATE["minecraft:plains"]

# block base names whose tinted faces use the FOLIAGE colormap; all other
# tinted faces use the grass colormap (vanilla hardcodes this per block)
FOLIAGE_TINTED = frozenset(
    f"minecraft:{n}_leaves"
    for n in ("oak", "jungle", "acacia", "dark_oak", "mangrove", "azalea")
) | {"minecraft:vine"}

# blocks whose tint is fixed regardless of climate (vanilla constants)
FIXED_TINT = {
    "minecraft:spruce_leaves": (97, 153, 97),
    "minecraft:birch_leaves": (128, 167, 85),
    "minecraft:cherry_leaves": None,  # untinted
}

# base names that take a biome tint at all (tintindex in their models)
GRASS_TINTED = frozenset(
    {
        "minecraft:grass_block",
        "minecraft:grass",
        "minecraft:short_grass",
        "minecraft:tall_grass",
        "minecraft:fern",
        "minecraft:large_fern",
        "minecraft:sugar_cane",
        "minecraft:lily_pad",
    }
)

TINTED_BLOCKS = GRASS_TINTED | FOLIAGE_TINTED | set(FIXED_TINT)


def climate_of(biome: str) -> tuple[float, float]:
    return BIOME_CLIMATE.get(biome, _PLAINS)


def _sample_colormap(img: np.ndarray | None, temp: float, downfall: float,
                     fallback: tuple[int, int, int]):
    if img is None:
        return fallback
    t = min(max(temp, 0.0), 1.0)
    d = min(max(downfall, 0.0), 1.0) * t
    h, w = img.shape[:2]
    x = min(int((1.0 - t) * (w - 1)), w - 1)
    y = min(int((1.0 - d) * (h - 1)), h - 1)
    px = img[y, x]
    if len(px) == 4 and px[3] == 0:  # outside the colormap triangle
        return fallback
    return (int(px[0]), int(px[1]), int(px[2]))


class TintResolver:
    """Pack-backed biome tint lookup with built-in fallbacks.

    ``tint_rgb(block_base, biome)`` -> (r, g, b) or None (untinted)."""

    _GRASS_FALLBACK = (145, 189, 89)  # plains grass (the r3 constant)
    _FOLIAGE_FALLBACK = (72, 181, 24)

    def __init__(self, pack=None):
        self._grass = self._load(pack, "colormap/grass")
        self._foliage = self._load(pack, "colormap/foliage")

    @staticmethod
    def _load(pack, name):
        if pack is None:
            return None
        path = pack.texture_path(name)
        if path is None:
            return None
        from ..io.image import load_image

        img = load_image(path)
        if img.dtype != np.uint8:
            img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        return img

    def tint_rgb(self, block_base: str, biome: str | None):
        if block_base in FIXED_TINT:
            return FIXED_TINT[block_base]
        if block_base not in TINTED_BLOCKS:
            return None
        b = biome or "minecraft:plains"
        t, d = climate_of(b)
        if block_base in FOLIAGE_TINTED:
            return _sample_colormap(self._foliage, t, d, self._FOLIAGE_FALLBACK)
        return _sample_colormap(self._grass, t, d, self._GRASS_FALLBACK)
