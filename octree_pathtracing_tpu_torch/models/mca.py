"""Minecraft region (.mca, Anvil) ingestion -> octree voxels (copy of
``octree_pathtracing_tpu/models/mca.py``).

1. the region header (1024 chunk entries: 4 KiB-sector offset + length);
2. per chunk, zlib / gzip inflate and an NBT parse;
3. section decode: palette + packed block-state indices (1.16+ packing:
   ``floor(64 / bits)`` entries per long, none spanning two longs; bits =
   max(4, ceil(log2(palette size)))), vectorized;
4. blockstate -> global id through one shared dict ("minecraft:air" = 0);
5. voxels scattered into region-local coordinates with the vanilla section
   window [-4, 19] -> [0, 24), and one Morton-sorted octree build at
   REGION_OCTREE_DEPTH = 9 (512^3).

The C++ parser of ``csrc/mca_parser.cc`` does (1)-(3) faster (``native.py``);
this module is its numpy reference and the fallback where it cannot be built.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import zlib

import numpy as np

from ..octree.build import build_octree
from ..octree.node_pool import Octree
from .nbt import read_nbt, write_nbt

REGION_OCTREE_DEPTH = 9  # a region is 512 blocks wide
LOWEST_SECTION_INDEX = -4  # the vanilla height window
HIGHEST_SECTION_INDEX = 19
SECTION_W = 16


@dataclasses.dataclass
class Section:
    chunk_x: int  # region-local chunk coords [0, 32)
    chunk_z: int
    y_pos: int  # window-shifted section y in [0, 24)
    palette: list  # blockstate names (with property suffix)
    indices: np.ndarray  # (4096,) uint16 palette indices, YZX order
    # 1.18+ per-section biomes: 4x4x4 cells, YZX order (None = unknown)
    biome_palette: list | None = None
    biome_indices: np.ndarray | None = None  # (64,) uint16


def blockstate_key(entry) -> str:
    """Canonical blockstate string: name#prop=val,... with the properties
    sorted."""
    if isinstance(entry, str):
        return entry
    name = entry.get("Name", "minecraft:air")
    props = entry.get("Properties")
    if not props:
        return name
    items = ",".join(f"{k}={v}" for k, v in sorted(props.items()))
    return f"{name}#{items}"


def unpack_block_indices(data: np.ndarray, palette_size: int) -> np.ndarray:
    """Vectorized 1.16+ packed-index decode -> (4096,) palette indices."""
    if palette_size <= 1 or data is None or len(data) == 0:
        return np.zeros(4096, np.uint16)
    bits = max(4, int(np.ceil(np.log2(max(palette_size, 2)))))
    per_long = 64 // bits
    idx = np.arange(4096)
    word = idx // per_long
    shift = (idx % per_long) * bits
    longs = np.asarray(data, np.uint64)
    vals = (longs[word] >> shift.astype(np.uint64)) & np.uint64((1 << bits) - 1)
    return vals.astype(np.uint16)


def unpack_biome_indices(data, palette_size: int) -> np.ndarray:
    """Vectorized biome-cell decode -> (64,) palette indices.

    Biome packing differs from block packing only in the floor: bits =
    ``ceil(log2(size))`` with NO minimum-4 (a 2-biome section packs 1 bit)."""
    if palette_size <= 1 or data is None or len(data) == 0:
        return np.zeros(64, np.uint16)
    bits = max(1, int(np.ceil(np.log2(max(palette_size, 2)))))
    per_long = 64 // bits
    idx = np.arange(64)
    word = idx // per_long
    shift = (idx % per_long) * bits
    longs = np.asarray(data, np.uint64)
    vals = (longs[word] >> shift.astype(np.uint64)) & np.uint64((1 << bits) - 1)
    return vals.astype(np.uint16)


def parse_region_bytes(buf: bytes) -> list[Section]:
    """Parse one .mca file's chunks into sections (python/numpy path)."""
    sections: list[Section] = []
    if len(buf) < 8192:
        return sections
    for i in range(1024):
        off_entry = struct.unpack_from(">I", buf, i * 4)[0]
        sector_off = off_entry >> 8
        sector_count = off_entry & 0xFF
        if sector_off == 0 or sector_count == 0:
            continue
        base = sector_off * 4096
        if base + 5 > len(buf):
            continue
        length = struct.unpack_from(">I", buf, base)[0]
        comp = buf[base + 4]
        payload = buf[base + 5 : base + 4 + length]
        try:
            if comp == 2:
                raw = zlib.decompress(payload)
            elif comp == 1:
                import gzip

                raw = gzip.decompress(payload)
            elif comp == 3:
                raw = bytes(payload)
            else:
                continue
            root = read_nbt(raw)
        except Exception:
            continue
        sections.extend(_chunk_sections(i, root))
    return sections


def _chunk_sections(chunk_index: int, root: dict) -> list[Section]:
    # chunk_index -> local coords: x = the low 5 bits
    chunk_x = chunk_index & 0x1F
    chunk_z = chunk_index >> 5
    # 1.18+ layout: root["sections"]; older: root["Level"]["Sections"]
    secs = root.get("sections")
    if secs is None:
        secs = root.get("Level", {}).get("Sections", [])
    out = []
    for sec in secs:
        y_index = sec.get("Y", 0)
        if not (LOWEST_SECTION_INDEX <= y_index <= HIGHEST_SECTION_INDEX):
            continue  # outside the vanilla height window
        bs = sec.get("block_states")
        if bs is None:
            palette = sec.get("Palette")
            data = sec.get("BlockStates")
        else:
            palette = bs.get("palette")
            data = bs.get("data")
        if not palette:
            continue
        names = [blockstate_key(p) for p in palette]
        indices = unpack_block_indices(data, len(names))
        bio = sec.get("biomes")
        b_pal = b_idx = None
        if bio and bio.get("palette"):
            b_pal = [str(x) for x in bio["palette"]]
            b_idx = unpack_biome_indices(bio.get("data"), len(b_pal))
        out.append(
            Section(
                chunk_x=chunk_x,
                chunk_z=chunk_z,
                y_pos=y_index - LOWEST_SECTION_INDEX,
                palette=names,
                indices=indices,
                biome_palette=b_pal,
                biome_indices=b_idx,
            )
        )
    return out


def remap_sections(
    sections: list[Section],
    blockstate_map: dict[str, int] | None = None,
    biome_variants: bool = False,
) -> tuple[list[tuple[Section, np.ndarray]], dict[str, int]]:
    """Map each section's palette to global blockstate ids; air stays 0.

    ``biome_variants``: split biome-TINTED blockstates (``models/biomes.py``
    TINTED_BLOCKS) into per-biome variant ids keyed ``name@biome`` so the
    compiler can bake a per-biome tint color — per-voxel attributes become
    distinct leaf values under static shapes.  Mapped arrays are then
    (P, n_biomes) instead of (P,); untinted states repeat one id per column.
    """
    if blockstate_map is None:
        blockstate_map = {}
    blockstate_map.setdefault("minecraft:air", 0)
    blockstate_map.setdefault("minecraft:cave_air", 0)
    blockstate_map.setdefault("minecraft:void_air", 0)

    def gid(key: str) -> int:
        if key not in blockstate_map:
            blockstate_map[key] = len(blockstate_map)
        return blockstate_map[key]

    if biome_variants:
        from .biomes import TINTED_BLOCKS

    remapped = []
    for sec in sections:
        biomes = sec.biome_palette if biome_variants else None
        nb = len(biomes) if biomes else 1
        mapped = np.empty((len(sec.palette), nb), np.uint32)
        for j, name in enumerate(sec.palette):
            base = name.split("#", 1)[0]
            if base in ("minecraft:air", "minecraft:cave_air", "minecraft:void_air"):
                mapped[j] = 0
                continue
            if biomes and base in TINTED_BLOCKS:
                for k, b in enumerate(biomes):
                    mapped[j, k] = gid(f"{name}@{b}")
            else:
                mapped[j] = gid(name)
        remapped.append((sec, mapped if biome_variants else mapped[:, 0]))
    return remapped, blockstate_map


_LI = np.arange(4096)
_LX = (_LI & 0xF).astype(np.int64)
_LZ = ((_LI >> 4) & 0xF).astype(np.int64)
_LY = (_LI >> 8).astype(np.int64)
# voxel -> 4x4x4 biome cell, YZX cell order
_BIOME_CELL = ((_LY >> 2) * 16 + (_LZ >> 2) * 4 + (_LX >> 2)).astype(np.int64)


def _section_values(sec: Section, mapped: np.ndarray) -> np.ndarray:
    """(4096,) global ids for a section; handles (P,) and biome-variant
    (P, n_biomes) mapped tables."""
    if mapped.ndim == 1:
        return mapped[sec.indices]
    if mapped.shape[1] == 1 or sec.biome_indices is None:
        return mapped[sec.indices, 0]
    bio = np.clip(sec.biome_indices[_BIOME_CELL], 0, mapped.shape[1] - 1)
    return mapped[sec.indices, bio]


def parse_sections(buf: bytes, use_native: bool = True) -> tuple[list[Section], str, str | None]:
    """One region's sections: the C++ parser's where it builds and parses,
    else the numpy parser's.  Returns (sections, the parser that ran,
    "native" or "numpy", and why the native one did not, or None)."""
    error = "not asked for"
    if use_native:
        try:
            from .native import parse_region_native

            return parse_region_native(buf), "native", None
        except Exception as e:  # no compiler, no zlib, or a malformed file
            error = f"{type(e).__name__}: {e}"
    return parse_region_bytes(buf), "numpy", error


def build_region_octree(
    buf: bytes,
    blockstate_map: dict[str, int] | None = None,
    depth: int = REGION_OCTREE_DEPTH,
    use_native: bool = True,
    biome_variants: bool = False,
) -> tuple[Octree | None, dict[str, int]]:
    """Full .mca -> octree pipeline; returns (octree, blockstate_map).

    Coordinates: x = chunk_x*16+lx, y = y_pos*16+ly, z = chunk_z*16+lz —
    region-local voxels in [0, 512) x [0, 384) x [0, 512).

    ``biome_variants``: emit per-biome leaf ids for tinted blockstates (see
    ``remap_sections``).  The native parser emits biome palettes since
    protocol v2, so pack worlds take the C++ fast path too.
    """
    sections = parse_sections(buf, use_native)[0]
    remapped, blockstate_map = remap_sections(
        sections, blockstate_map, biome_variants=biome_variants
    )

    coords_list = []
    vals_list = []
    # section-local YZX order (vanilla): i = (y*16 + z)*16 + x
    lx, ly, lz = _LX, _LY, _LZ
    for sec, mapped in remapped:
        vals = _section_values(sec, mapped)
        nz = np.nonzero(vals)[0]
        if nz.size == 0:
            continue
        x = sec.chunk_x * SECTION_W + lx[nz]
        y = sec.y_pos * SECTION_W + ly[nz]
        z = sec.chunk_z * SECTION_W + lz[nz]
        coords_list.append(np.stack([x, y, z], -1))
        vals_list.append(vals[nz])
    if not coords_list:
        return None, blockstate_map
    coords = np.concatenate(coords_list)
    values = np.concatenate(vals_list)
    return build_octree(coords, values, depth), blockstate_map


def _region_coords_from_name(name: str) -> tuple[int, int]:
    """'r.X.Z.mca' -> (X, Z); unknown names map to (0, 0)."""
    parts = os.path.basename(name).split(".")
    try:
        return int(parts[1]), int(parts[2])
    except (IndexError, ValueError):
        return 0, 0


def load_world(
    path: str,
    origin=None,
    depth: int = REGION_OCTREE_DEPTH,
    blockstate_map: dict[str, int] | None = None,
    use_native: bool = True,
    biome_variants: bool = False,
):
    """Load a world directory or single region file into one octree.

    A directory loads every ``region/*.mca``, stitching regions by their
    r.X.Z grid coordinates into one octree, with the world re-based to the
    loaded bounding box's min corner; the octree grows past ``depth`` where
    the stitched world is wider than ``2**depth``.
    """
    if os.path.isdir(path):
        region_dir = os.path.join(path, "region")
        if not os.path.isdir(region_dir):
            region_dir = path
        files = sorted(f for f in os.listdir(region_dir) if f.endswith(".mca"))
        if not files:
            raise FileNotFoundError(f"no .mca files under {region_dir}")
        paths = [os.path.join(region_dir, f) for f in files]
    else:
        paths = [path]

    if len(paths) == 1:
        with open(paths[0], "rb") as f:
            return build_region_octree(
                f.read(), blockstate_map, depth, use_native,
                biome_variants=biome_variants,
            )

    # multi-region stitch: gather voxels in world coords, re-base, one build
    if blockstate_map is None:
        blockstate_map = {}
    if biome_variants:
        use_native = False  # biome palettes come from the python path only
    all_coords, all_vals = [], []
    lx, ly, lz = _LX, _LY, _LZ
    coords_rxz = [_region_coords_from_name(p) for p in paths]
    min_rx = min(c[0] for c in coords_rxz)
    min_rz = min(c[1] for c in coords_rxz)
    for p, (rx, rz) in zip(paths, coords_rxz):
        with open(p, "rb") as f:
            buf = f.read()
        sections = parse_sections(buf, use_native)[0]
        remapped, blockstate_map = remap_sections(
            sections, blockstate_map, biome_variants=biome_variants
        )
        ox = (rx - min_rx) * 512
        oz = (rz - min_rz) * 512
        for sec, mapped in remapped:
            vals = _section_values(sec, mapped)
            nz = np.nonzero(vals)[0]
            if nz.size == 0:
                continue
            x = ox + sec.chunk_x * SECTION_W + lx[nz]
            y = sec.y_pos * SECTION_W + ly[nz]
            z = oz + sec.chunk_z * SECTION_W + lz[nz]
            all_coords.append(np.stack([x, y, z], -1))
            all_vals.append(vals[nz])
    if not all_coords:
        return None, blockstate_map
    coords = np.concatenate(all_coords)
    values = np.concatenate(all_vals)
    span = int(coords.max()) + 1
    world_depth = max(depth, int(np.ceil(np.log2(max(span, 2)))))
    return build_octree(coords, values, world_depth), blockstate_map


# ---------------- fixture synthesis (tests) ----------------


def make_region_fixture(chunks: dict[tuple[int, int], dict]) -> bytes:
    """Build a minimal .mca byte blob.

    ``chunks``: {(chunk_x, chunk_z): {section_y: (palette names, (4096,)
    indices)}}.  A section value may carry a third element describing its
    biomes: a single biome name (whole section) or ``(biome names, (64,)
    cell indices)``.
    """
    header = bytearray(8192)
    body = bytearray()
    next_sector = 2
    for (cx, cz), secs in chunks.items():
        sections = []
        for y, spec in sorted(secs.items()):
            palette, indices = spec[0], spec[1]
            biome_spec = spec[2] if len(spec) > 2 else None
            bits = max(4, int(np.ceil(np.log2(max(len(palette), 2)))))
            per_long = 64 // bits
            n_longs = (4096 + per_long - 1) // per_long
            longs = np.zeros(n_longs, np.uint64)
            idx = np.arange(4096)
            np.bitwise_or.at(
                longs,
                idx // per_long,
                np.asarray(indices, np.uint64) << ((idx % per_long) * bits).astype(np.uint64),
            )
            sec_nbt = {
                "Y": int(y),
                "block_states": {
                    "palette": [
                        {"Name": n.split("#")[0]}
                        | (
                            {
                                "Properties": dict(
                                    kv.split("=") for kv in n.split("#")[1].split(",")
                                )
                            }
                            if "#" in n
                            else {}
                        )
                        for n in palette
                    ],
                    "data": longs.astype(np.int64),
                },
            }
            if biome_spec is not None:
                if isinstance(biome_spec, str):
                    sec_nbt["biomes"] = {"palette": [biome_spec]}
                else:
                    b_pal, b_idx = biome_spec
                    b_bits = max(1, int(np.ceil(np.log2(max(len(b_pal), 2)))))
                    b_per = 64 // b_bits
                    b_longs = np.zeros((64 + b_per - 1) // b_per, np.uint64)
                    bi = np.arange(64)
                    np.bitwise_or.at(
                        b_longs,
                        bi // b_per,
                        np.asarray(b_idx, np.uint64)
                        << ((bi % b_per) * b_bits).astype(np.uint64),
                    )
                    sec_nbt["biomes"] = {
                        "palette": list(b_pal),
                        "data": b_longs.astype(np.int64),
                    }
            sections.append(sec_nbt)
        root = {"sections": sections, "xPos": cx, "zPos": cz}
        raw = write_nbt(root)
        comp = zlib.compress(raw)
        payload = struct.pack(">I", len(comp) + 1) + bytes([2]) + comp
        sectors = (len(payload) + 4095) // 4096
        padded = payload + b"\0" * (sectors * 4096 - len(payload))
        i = (cx & 0x1F) | ((cz & 0x1F) << 5)
        struct.pack_into(">I", header, i * 4, (next_sector << 8) | sectors)
        body += padded
        next_sector += sectors
    return bytes(header) + bytes(body)
