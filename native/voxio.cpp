// voxio — native data-loading runtime for voxtracer.
//
// Host-side counterpart of the reference's C++ asset path (ogt_vox parser
// + stb image, lib/ogt_vox.h + lib/stb_image.h): a small, dependency-free
// shared library doing the hot host-side work — MagicaVoxel RIFF parsing
// (including the IMAP display-order remap and palette rotation semantics,
// ogt_vox.h:2004-2047), uniform-brick macro-grid construction for the
// two-level DDA, and PNG encoding for frame output.  Exposed over a C ABI
// consumed via ctypes (voxtracer/native/__init__.py).
//
// Build: see native/build.sh (g++ -O2 -shared -fPIC, links zlib).

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <vector>
#include <zlib.h>

namespace {

struct Chunk {
    const uint8_t* content;
    int64_t content_size;
    const uint8_t* children;
    int64_t children_size;
    char id[5];
};

int32_t read_i32(const uint8_t* p) {
    int32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

// Walk a run of sibling chunks; returns false when exhausted.
bool next_chunk(const uint8_t*& cursor, const uint8_t* end, Chunk& out) {
    if (cursor + 12 > end) return false;
    std::memcpy(out.id, cursor, 4);
    out.id[4] = 0;
    out.content_size = read_i32(cursor + 4);
    out.children_size = read_i32(cursor + 8);
    out.content = cursor + 12;
    out.children = out.content + out.content_size;
    cursor = out.children + out.children_size;
    return out.children + out.children_size <= end + 0 || true;
}

struct ParseState {
    int32_t sx = 0, sy = 0, sz = 0;          // first model only
    const uint8_t* xyzi = nullptr;            // first model voxel run
    int32_t n_voxels = 0;
    const uint8_t* rgba = nullptr;            // 256*4
    const uint8_t* imap = nullptr;            // 256
    bool have_model = false;
};

void walk(const uint8_t* cursor, const uint8_t* end, ParseState& st) {
    Chunk c;
    while (cursor + 12 <= end) {
        if (!next_chunk(cursor, end, c)) return;
        if (!std::strncmp(c.id, "MAIN", 4)) {
            walk(c.children, c.children + c.children_size, st);
        } else if (!std::strncmp(c.id, "SIZE", 4) && !st.have_model) {
            st.sx = read_i32(c.content);
            st.sy = read_i32(c.content + 4);
            st.sz = read_i32(c.content + 8);
        } else if (!std::strncmp(c.id, "XYZI", 4) && !st.have_model) {
            st.n_voxels = read_i32(c.content);
            st.xyzi = c.content + 4;
            st.have_model = true;              // reference uses models[0]
        } else if (!std::strncmp(c.id, "RGBA", 4)) {
            st.rgba = c.content;
        } else if (!std::strncmp(c.id, "IMAP", 4)) {
            st.imap = c.content;
        }
    }
}

}  // namespace

extern "C" {

// Pass 1: dimensions of model 0.  Returns 0 on success.
int vox_dims(const uint8_t* data, int64_t len, int32_t dims_out[3]) {
    if (len < 8 || std::memcmp(data, "VOX ", 4)) return -1;
    ParseState st;
    walk(data + 8, data + len, st);
    if (!st.have_model) return -2;
    dims_out[0] = st.sx;
    dims_out[1] = st.sy;
    dims_out[2] = st.sz;
    return 0;
}

// Pass 2: fill caller-allocated grid [sx*sy*sz] (index = (x*sy + y)*sz + z,
// 0 = empty) and palette [256*4] float RGBA in [0,1].  Applies the IMAP
// remap (v -> (1 + inverse[v]) & 0xFF) and the ogt_vox palette rotation.
int vox_fill(const uint8_t* data, int64_t len, uint8_t* grid,
             float* palette_out) {
    if (len < 8 || std::memcmp(data, "VOX ", 4)) return -1;
    ParseState st;
    walk(data + 8, data + len, st);
    if (!st.have_model) return -2;

    uint8_t pal[256][4];
    if (st.rgba) {
        std::memcpy(pal, st.rgba, 256 * 4);
    } else {
        for (int i = 0; i < 256; i++) {
            pal[i][0] = pal[i][1] = pal[i][2] = (uint8_t)i;
            pal[i][3] = 255;
        }
    }

    uint8_t remap[256];
    for (int i = 0; i < 256; i++) remap[i] = (uint8_t)i;
    if (st.imap) {
        uint8_t inverse[256] = {0};
        for (int i = 0; i < 256; i++) inverse[st.imap[i]] = (uint8_t)i;
        for (int i = 0; i < 256; i++) remap[i] = (uint8_t)((1 + inverse[i]) & 0xFF);
        uint8_t reordered[256][4];
        for (int i = 0; i < 256; i++) {
            std::memcpy(reordered[i], pal[(st.imap[i] + 255) & 0xFF], 4);
        }
        std::memcpy(pal, reordered, sizeof(pal));
    }
    // rotate so voxel index looks up directly (ogt_vox.h:2040-2047)
    uint8_t rotated[256][4];
    std::memcpy(rotated[0], pal[255], 4);
    for (int i = 1; i < 256; i++) std::memcpy(rotated[i], pal[i - 1], 4);
    rotated[0][3] = 0;
    for (int i = 0; i < 256; i++)
        for (int c = 0; c < 4; c++)
            palette_out[i * 4 + c] = rotated[i][c] / 255.0f;

    const int64_t cells = (int64_t)st.sx * st.sy * st.sz;
    std::memset(grid, 0, cells);
    for (int32_t i = 0; i < st.n_voxels; i++) {
        const uint8_t* v = st.xyzi + 4 * i;
        if (v[0] >= st.sx || v[1] >= st.sy || v[2] >= st.sz) continue;
        grid[((int64_t)v[0] * st.sy + v[1]) * st.sz + v[2]] = remap[v[3]];
    }
    return 0;
}

// Uniform-brick macro grid: bricks[m^3] (index (bx*m+by)*m+bz) gets the
// uniform cell value of the 8^3 (clipped) brick, else -1.
void vox_build_bricks(const uint8_t* grid, int32_t g, int32_t* bricks,
                      int32_t m, uint8_t empty_value) {
    const int B = 8;
    for (int bx = 0; bx < m; bx++)
        for (int by = 0; by < m; by++)
            for (int bz = 0; bz < m; bz++) {
                int x1 = bx * B, x2 = (bx + 1) * B < g ? (bx + 1) * B : g;
                int y1 = by * B, y2 = (by + 1) * B < g ? (by + 1) * B : g;
                int z1 = bz * B, z2 = (bz + 1) * B < g ? (bz + 1) * B : g;
                uint8_t first = grid[((int64_t)x1 * g + y1) * g + z1];
                bool uniform = true;
                for (int x = x1; uniform && x < x2; x++)
                    for (int y = y1; uniform && y < y2; y++) {
                        const uint8_t* row = grid + ((int64_t)x * g + y) * g;
                        for (int z = z1; z < z2; z++)
                            if (row[z] != first) { uniform = false; break; }
                    }
                bricks[((int64_t)bx * m + by) * m + bz] = uniform ? first : -1;
                (void)empty_value;
            }
}

// Minimal PNG writer (8-bit RGB, zlib-deflated, filter 0 rows).
// Returns 0 on success.
int png_write(const char* path, const uint8_t* rgb, int32_t w, int32_t h) {
    std::vector<uint8_t> raw((size_t)h * (w * 3 + 1));
    for (int y = 0; y < h; y++) {
        raw[(size_t)y * (w * 3 + 1)] = 0;
        std::memcpy(&raw[(size_t)y * (w * 3 + 1) + 1], rgb + (size_t)y * w * 3,
                    (size_t)w * 3);
    }
    uLongf comp_cap = compressBound(raw.size());
    std::vector<uint8_t> comp(comp_cap);
    if (compress2(comp.data(), &comp_cap, raw.data(), raw.size(), 6) != Z_OK)
        return -1;

    FILE* f = std::fopen(path, "wb");
    if (!f) return -2;
    auto be32 = [](uint32_t v, uint8_t* o) {
        o[0] = v >> 24; o[1] = v >> 16; o[2] = v >> 8; o[3] = v;
    };
    auto chunk = [&](const char tag[4], const uint8_t* d, uint32_t n) {
        uint8_t hdr[8];
        be32(n, hdr);
        std::memcpy(hdr + 4, tag, 4);
        std::fwrite(hdr, 1, 8, f);
        if (n) std::fwrite(d, 1, n, f);
        uLong crc = crc32(0, (const Bytef*)tag, 4);
        if (n) crc = crc32(crc, d, n);
        uint8_t crcb[4];
        be32((uint32_t)crc, crcb);
        std::fwrite(crcb, 1, 4, f);
    };
    const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
    std::fwrite(sig, 1, 8, f);
    uint8_t ihdr[13];
    be32((uint32_t)w, ihdr);
    be32((uint32_t)h, ihdr + 4);
    ihdr[8] = 8; ihdr[9] = 2; ihdr[10] = 0; ihdr[11] = 0; ihdr[12] = 0;
    chunk("IHDR", ihdr, 13);
    chunk("IDAT", comp.data(), (uint32_t)comp_cap);
    chunk("IEND", nullptr, 0);
    std::fclose(f);
    return 0;
}

}  // extern "C"
