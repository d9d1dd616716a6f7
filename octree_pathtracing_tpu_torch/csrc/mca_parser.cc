// Native Minecraft region (.mca) parser — the hot world-ingestion path.
//
// A copy of the JAX package's native/mca_parser.cc: the region header, zlib
// chunk inflate, the NBT walk to sections (Y, block_states.palette,
// block_states.data) and the 1.16+ packed-index unpack.  Host code, built
// with g++ and -lz at first use; Python binds it through ctypes
// (models/native.py), and the numpy parser of models/mca.py is its
// semantic reference.
//
// Output protocol v2 per section (little-endian):
//   i32 chunk_x, i32 chunk_z, i32 y_pos, i32 palette_count
//   palette_count x { u16 len; bytes utf8 }   (name#prop=val,... canonical)
//   4096 x u16 palette indices (section-local YZX order)
//   i32 biome_palette_count (0 = section had no biome tag)
//   biome_palette_count x { u16 len; bytes utf8 }
//   [if biome_palette_count > 0] 64 x u16 biome cell indices (4x4x4 YZX,
//       1.18+ packing: bits = ceil(log2(count)), NO minimum-4 floor —
//       mirrors models/mca.py unpack_biome_indices)
//
// parse_region() returns the number of sections, writing the blob into the
// caller's buffer; returns -(needed_bytes) if the buffer is too small, -1 on
// malformed input.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <map>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

struct Writer {
  uint8_t* out;
  int64_t cap;
  int64_t pos = 0;
  int64_t needed = 0;

  void raw(const void* p, int64_t n) {
    needed += n;
    if (pos + n <= cap) {
      memcpy(out + pos, p, n);
      pos += n;
    } else {
      pos = cap + 1;  // poison
    }
  }
  template <typename T>
  void put(T v) {
    raw(&v, sizeof(T));
  }
};

struct Cursor {
  const uint8_t* p;
  int64_t len;
  int64_t pos = 0;
  bool fail = false;

  uint8_t u8() {
    if (pos + 1 > len) { fail = true; return 0; }
    return p[pos++];
  }
  uint16_t u16() {
    if (pos + 2 > len) { fail = true; return 0; }
    uint16_t v = (uint16_t(p[pos]) << 8) | p[pos + 1];
    pos += 2;
    return v;
  }
  uint32_t u32() {
    if (pos + 4 > len) { fail = true; return 0; }
    uint32_t v = 0;
    for (int i = 0; i < 4; i++) v = (v << 8) | p[pos + i];
    pos += 4;
    return v;
  }
  uint64_t u64() {
    if (pos + 8 > len) { fail = true; return 0; }
    uint64_t v = 0;
    for (int i = 0; i < 8; i++) v = (v << 8) | p[pos + i];
    pos += 8;
    return v;
  }
  std::string str() {
    uint16_t n = u16();
    if (pos + n > len) { fail = true; return {}; }
    std::string s(reinterpret_cast<const char*>(p + pos), n);
    pos += n;
    return s;
  }
  void skip(int64_t n) {
    pos += n;
    if (pos > len) fail = true;
  }
};

constexpr int TAG_END = 0, TAG_BYTE = 1, TAG_SHORT = 2, TAG_INT = 3,
              TAG_LONG = 4, TAG_FLOAT = 5, TAG_DOUBLE = 6, TAG_BYTE_ARRAY = 7,
              TAG_STRING = 8, TAG_LIST = 9, TAG_COMPOUND = 10,
              TAG_INT_ARRAY = 11, TAG_LONG_ARRAY = 12;

struct PaletteEntry {
  std::string name;
  std::map<std::string, std::string> props;
};

struct SectionData {
  int32_t y = 0;
  bool has_y = false;
  std::vector<PaletteEntry> palette;
  std::vector<uint64_t> data;
  std::vector<std::string> biome_palette;
  std::vector<uint64_t> biome_data;
};

// Skip a payload of the given tag.
void skip_payload(Cursor& c, int tag);

void skip_compound(Cursor& c) {
  while (!c.fail) {
    int t = c.u8();
    if (t == TAG_END) return;
    c.str();
    skip_payload(c, t);
  }
}

void skip_payload(Cursor& c, int tag) {
  switch (tag) {
    case TAG_BYTE: c.skip(1); break;
    case TAG_SHORT: c.skip(2); break;
    case TAG_INT: case TAG_FLOAT: c.skip(4); break;
    case TAG_LONG: case TAG_DOUBLE: c.skip(8); break;
    case TAG_BYTE_ARRAY: { uint32_t n = c.u32(); c.skip(n); break; }
    case TAG_STRING: { uint16_t n = c.u16(); c.skip(n); break; }
    case TAG_LIST: {
      int it = c.u8();
      uint32_t n = c.u32();
      for (uint32_t i = 0; i < n && !c.fail; i++) skip_payload(c, it);
      break;
    }
    case TAG_COMPOUND: skip_compound(c); break;
    case TAG_INT_ARRAY: { uint32_t n = c.u32(); c.skip(int64_t(n) * 4); break; }
    case TAG_LONG_ARRAY: { uint32_t n = c.u32(); c.skip(int64_t(n) * 8); break; }
    default: c.fail = true;
  }
}

void parse_palette_entry(Cursor& c, PaletteEntry& e) {
  while (!c.fail) {
    int t = c.u8();
    if (t == TAG_END) return;
    std::string name = c.str();
    if (t == TAG_STRING && name == "Name") {
      e.name = c.str();
    } else if (t == TAG_COMPOUND && name == "Properties") {
      while (!c.fail) {
        int pt = c.u8();
        if (pt == TAG_END) break;
        std::string k = c.str();
        if (pt == TAG_STRING) {
          e.props[k] = c.str();
        } else {
          skip_payload(c, pt);
        }
      }
    } else {
      skip_payload(c, t);
    }
  }
}

void parse_block_states(Cursor& c, SectionData& s) {
  while (!c.fail) {
    int t = c.u8();
    if (t == TAG_END) return;
    std::string name = c.str();
    if (t == TAG_LIST && name == "palette") {
      int it = c.u8();
      uint32_t n = c.u32();
      for (uint32_t i = 0; i < n && !c.fail; i++) {
        PaletteEntry e;
        if (it == TAG_COMPOUND) {
          parse_palette_entry(c, e);
        } else {
          skip_payload(c, it);
        }
        s.palette.push_back(std::move(e));
      }
    } else if (t == TAG_LONG_ARRAY && name == "data") {
      uint32_t n = c.u32();
      s.data.resize(n);
      for (uint32_t i = 0; i < n && !c.fail; i++) s.data[i] = c.u64();
    } else {
      skip_payload(c, t);
    }
  }
}

void parse_biomes(Cursor& c, SectionData& s) {
  while (!c.fail) {
    int t = c.u8();
    if (t == TAG_END) return;
    std::string name = c.str();
    if (t == TAG_LIST && name == "palette") {
      int it = c.u8();
      uint32_t n = c.u32();
      for (uint32_t i = 0; i < n && !c.fail; i++) {
        if (it == TAG_STRING) {
          s.biome_palette.push_back(c.str());
        } else {
          skip_payload(c, it);
        }
      }
    } else if (t == TAG_LONG_ARRAY && name == "data") {
      uint32_t n = c.u32();
      s.biome_data.resize(n);
      for (uint32_t i = 0; i < n && !c.fail; i++) s.biome_data[i] = c.u64();
    } else {
      skip_payload(c, t);
    }
  }
}

void parse_section(Cursor& c, SectionData& s) {
  while (!c.fail) {
    int t = c.u8();
    if (t == TAG_END) return;
    std::string name = c.str();
    if (t == TAG_BYTE && name == "Y") {
      s.y = int8_t(c.u8());
      s.has_y = true;
    } else if (t == TAG_INT && name == "Y") {
      s.y = int32_t(c.u32());
      s.has_y = true;
    } else if (t == TAG_COMPOUND && name == "block_states") {
      parse_block_states(c, s);
    } else if (t == TAG_COMPOUND && name == "biomes") {
      parse_biomes(c, s);
    } else {
      skip_payload(c, t);
    }
  }
}

// Walk a chunk-root compound for "sections" (1.18+). Returns sections.
void parse_chunk_root(Cursor& c, std::vector<SectionData>& out) {
  while (!c.fail) {
    int t = c.u8();
    if (t == TAG_END) return;
    std::string name = c.str();
    if (t == TAG_LIST && (name == "sections" || name == "Sections")) {
      int it = c.u8();
      uint32_t n = c.u32();
      for (uint32_t i = 0; i < n && !c.fail; i++) {
        if (it == TAG_COMPOUND) {
          SectionData s;
          parse_section(c, s);
          if (s.has_y && !s.palette.empty()) out.push_back(std::move(s));
        } else {
          skip_payload(c, it);
        }
      }
    } else if (t == TAG_COMPOUND && name == "Level") {
      parse_chunk_root(c, out);  // pre-1.18 nesting
    } else {
      skip_payload(c, t);
    }
  }
}

constexpr int LOWEST_SECTION = -4, HIGHEST_SECTION = 19;

}  // namespace

extern "C" int64_t parse_region(const uint8_t* buf, int64_t len, uint8_t* out,
                                int64_t out_cap) {
  if (len < 8192) return -1;
  Writer w{out, out_cap};
  int64_t n_sections = 0;
  std::vector<uint8_t> inflated;
  inflated.reserve(1 << 20);

  for (int i = 0; i < 1024; i++) {
    uint32_t entry = 0;
    for (int k = 0; k < 4; k++) entry = (entry << 8) | buf[i * 4 + k];
    uint32_t sector = entry >> 8, count = entry & 0xFF;
    if (!sector || !count) continue;
    int64_t base = int64_t(sector) * 4096;
    if (base + 5 > len) continue;
    uint32_t clen = 0;
    for (int k = 0; k < 4; k++) clen = (clen << 8) | buf[base + k];
    if (clen < 1 || base + 4 + clen > len) continue;
    int comp = buf[base + 4];
    const uint8_t* payload = buf + base + 5;
    int64_t plen = clen - 1;

    const uint8_t* raw;
    int64_t rlen;
    if (comp == 2 || comp == 1) {
      inflated.clear();
      inflated.resize(std::max<int64_t>(plen * 8, 1 << 16));
      z_stream zs{};
      // windowBits 15+32: auto-detect zlib/gzip headers
      if (inflateInit2(&zs, 15 + 32) != Z_OK) continue;
      zs.next_in = const_cast<uint8_t*>(payload);
      zs.avail_in = uInt(plen);
      int ret = Z_OK;
      size_t off = 0;
      while (ret == Z_OK) {
        if (off == inflated.size()) inflated.resize(inflated.size() * 2);
        zs.next_out = inflated.data() + off;
        zs.avail_out = uInt(inflated.size() - off);
        ret = inflate(&zs, Z_NO_FLUSH);
        off = inflated.size() - zs.avail_out;
      }
      inflateEnd(&zs);
      if (ret != Z_STREAM_END) continue;
      raw = inflated.data();
      rlen = int64_t(off);
    } else if (comp == 3) {
      raw = payload;
      rlen = plen;
    } else {
      continue;
    }

    Cursor c{raw, rlen};
    if (c.u8() != TAG_COMPOUND) continue;
    c.str();
    std::vector<SectionData> secs;
    parse_chunk_root(c, secs);

    int32_t cx = i & 0x1F, cz = i >> 5;
    for (auto& s : secs) {
      if (s.y < LOWEST_SECTION || s.y > HIGHEST_SECTION) continue;
      w.put<int32_t>(cx);
      w.put<int32_t>(cz);
      w.put<int32_t>(s.y - LOWEST_SECTION);
      w.put<int32_t>(int32_t(s.palette.size()));
      for (auto& e : s.palette) {
        std::string canonical = e.name;
        if (!e.props.empty()) {
          canonical += "#";
          bool first = true;
          for (auto& kv : e.props) {  // std::map iterates sorted
            if (!first) canonical += ",";
            first = false;
            canonical += kv.first + "=" + kv.second;
          }
        }
        w.put<uint16_t>(uint16_t(canonical.size()));
        w.raw(canonical.data(), int64_t(canonical.size()));
      }
      // unpack indices (1.16+ packing, no spanning)
      uint16_t indices[4096];
      size_t psize = s.palette.size();
      if (psize <= 1 || s.data.empty()) {
        memset(indices, 0, sizeof(indices));
      } else {
        int bits = 4;
        while ((size_t(1) << bits) < psize) bits++;
        int per_long = 64 / bits;
        uint64_t mask = (uint64_t(1) << bits) - 1;
        for (int j = 0; j < 4096; j++) {
          size_t word = size_t(j) / per_long;
          int shift = (j % per_long) * bits;
          uint64_t v = word < s.data.size() ? (s.data[word] >> shift) & mask : 0;
          indices[j] = uint16_t(v);
        }
      }
      w.raw(indices, sizeof(indices));

      // biome tail (protocol v2)
      w.put<int32_t>(int32_t(s.biome_palette.size()));
      for (auto& name : s.biome_palette) {
        w.put<uint16_t>(uint16_t(name.size()));
        w.raw(name.data(), int64_t(name.size()));
      }
      if (!s.biome_palette.empty()) {
        uint16_t bcells[64];
        size_t bsize = s.biome_palette.size();
        if (bsize <= 1 || s.biome_data.empty()) {
          memset(bcells, 0, sizeof(bcells));
        } else {
          int bits = 1;
          while ((size_t(1) << bits) < bsize) bits++;
          int per_long = 64 / bits;
          uint64_t mask = (uint64_t(1) << bits) - 1;
          for (int j = 0; j < 64; j++) {
            size_t word = size_t(j) / per_long;
            int shift = (j % per_long) * bits;
            uint64_t v =
                word < s.biome_data.size() ? (s.biome_data[word] >> shift) & mask : 0;
            bcells[j] = uint16_t(v);
          }
        }
        w.raw(bcells, sizeof(bcells));
      }
      n_sections++;
    }
  }
  if (w.needed > out_cap) return -w.needed;
  return n_sections;
}

extern "C" int64_t native_abi_version() { return 2; }
