// Native tiled/strip grayscale TIFF reader + streaming prescan.
//
// This build's equivalent of the reference's libtiff loaders
// (reference: src/nyx/grayscale_tiff.h NyxusGrayscaleTiffTileLoader /
// NyxusGrayscaleTiffStripLoader) re-designed as a region server: the Python
// pipeline asks for arbitrary [y0:y0+h, x0:x0+w) regions (ROI batches, tile
// windows) and the reader decodes only the overlapping TIFF tiles/strips,
// converting any sample layout (u8/u16/u32/i8/i16/i32/f32/f64, tiled or
// stripped) into a dense float32 or uint32 buffer suitable for dlpack-free
// zero-copy handoff into numpy/JAX.
//
// All functions are extern "C" for ctypes binding (pybind11 is not available
// in this environment).

#include <tiffio.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <list>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct TiffHandle {
    TIFF* tif = nullptr;
    uint32_t width = 0, height = 0;
    uint32_t tile_w = 0, tile_h = 0;   // strip files: tile_h = rows-per-strip
    bool tiled = false;
    uint16_t bits = 0;
    uint16_t sample_format = SAMPLEFORMAT_UINT;
    uint16_t spp = 1;
    // bounded LRU of decoded blocks: streamed pipelines read many small
    // per-ROI regions that land in the same LZW tiles; without this every
    // region re-decodes its covering tiles (measured ~100x redundancy on
    // a dense streamed slide).  ~32 MB keeps a 6x6 grid of 512^2 u16
    // tiles hot.
    static constexpr size_t kCacheCapBytes = 32u << 20;
    std::list<std::pair<uint64_t, std::vector<uint8_t>>> lru;
    std::unordered_map<uint64_t,
        std::list<std::pair<uint64_t, std::vector<uint8_t>>>::iterator>
        lru_idx;
    size_t lru_bytes = 0;
};

// Convert one row-segment of raw samples to float32 / uint32.
template <typename SrcT, typename DstT>
void convert_row(const uint8_t* src, DstT* dst, size_t n, uint16_t spp) {
    const SrcT* s = reinterpret_cast<const SrcT*>(src);
    if (spp == 1) {
        for (size_t i = 0; i < n; i++) dst[i] = static_cast<DstT>(s[i]);
    } else {
        for (size_t i = 0; i < n; i++)
            dst[i] = static_cast<DstT>(s[i * spp]);  // first channel
    }
}

template <typename DstT>
bool convert_dispatch(const TiffHandle* h, const uint8_t* src, DstT* dst,
                      size_t n) {
    switch (h->sample_format) {
        case SAMPLEFORMAT_UINT:
        case SAMPLEFORMAT_VOID:
            switch (h->bits) {
                case 8:  convert_row<uint8_t>(src, dst, n, h->spp); return true;
                case 16: convert_row<uint16_t>(src, dst, n, h->spp); return true;
                case 32: convert_row<uint32_t>(src, dst, n, h->spp); return true;
                case 64: convert_row<uint64_t>(src, dst, n, h->spp); return true;
            }
            return false;
        case SAMPLEFORMAT_INT:
            switch (h->bits) {
                case 8:  convert_row<int8_t>(src, dst, n, h->spp); return true;
                case 16: convert_row<int16_t>(src, dst, n, h->spp); return true;
                case 32: convert_row<int32_t>(src, dst, n, h->spp); return true;
                case 64: convert_row<int64_t>(src, dst, n, h->spp); return true;
            }
            return false;
        case SAMPLEFORMAT_IEEEFP:
            switch (h->bits) {
                case 32: convert_row<float>(src, dst, n, h->spp); return true;
                case 64: convert_row<double>(src, dst, n, h->spp); return true;
            }
            return false;
    }
    return false;
}

// Decode (or fetch from the LRU) the tile/strip containing (y, x); report
// its top-left origin + dimensions and return a pointer to the decoded
// bytes (owned by the cache; valid until the next load_block call that
// evicts it -- callers consume it immediately).
const uint8_t* load_block(TiffHandle* h, uint32_t y, uint32_t x, uint32_t* by,
                          uint32_t* bx, uint32_t* bh, uint32_t* bw) {
    uint64_t key;
    tmsize_t sz;
    if (h->tiled) {
        *by = (y / h->tile_h) * h->tile_h;
        *bx = (x / h->tile_w) * h->tile_w;
        *bh = h->tile_h;
        *bw = h->tile_w;
        key = ((uint64_t)(*by / h->tile_h) << 32) | (*bx / h->tile_w);
        sz = TIFFTileSize(h->tif);
    } else {
        uint32_t strip = y / h->tile_h;
        *by = strip * h->tile_h;
        *bx = 0;
        *bh = std::min<uint32_t>(h->tile_h, h->height - *by);
        *bw = h->width;
        key = strip;
        sz = TIFFStripSize(h->tif);
    }
    auto it = h->lru_idx.find(key);
    if (it != h->lru_idx.end()) {
        h->lru.splice(h->lru.begin(), h->lru, it->second);
        return it->second->second.data();
    }
    std::vector<uint8_t> buf((size_t)sz);
    if (h->tiled) {
        if (TIFFReadTile(h->tif, buf.data(), x, y, 0, 0) < 0) return nullptr;
    } else {
        uint32_t strip = y / h->tile_h;
        if (TIFFReadEncodedStrip(h->tif, strip, buf.data(), sz) < 0)
            return nullptr;
    }
    h->lru_bytes += buf.size();
    h->lru.emplace_front(key, std::move(buf));
    h->lru_idx[key] = h->lru.begin();
    while (h->lru_bytes > TiffHandle::kCacheCapBytes && h->lru.size() > 1) {
        h->lru_bytes -= h->lru.back().second.size();
        h->lru_idx.erase(h->lru.back().first);
        h->lru.pop_back();
    }
    return h->lru.begin()->second.data();
}

template <typename DstT>
int read_region_impl(TiffHandle* h, uint32_t y0, uint32_t x0, uint32_t rh,
                     uint32_t rw, DstT* out) {
    size_t samp_bytes = h->bits / 8;
    uint32_t y1 = std::min<uint32_t>(y0 + rh, h->height);
    uint32_t x1 = std::min<uint32_t>(x0 + rw, h->width);
    // zero-fill (covers out-of-image margins of padded regions)
    std::memset(out, 0, (size_t)rh * rw * sizeof(DstT));
    uint32_t step_y = h->tile_h, step_x = h->tiled ? h->tile_w : h->width;
    for (uint32_t by = (y0 / step_y) * step_y; by < y1; by += step_y) {
        for (uint32_t bx = (x0 / step_x) * step_x; bx < x1; bx += step_x) {
            uint32_t oy, ox, bh, bw;
            const uint8_t* block = load_block(h, by, bx, &oy, &ox, &bh, &bw);
            if (!block) return -2;
            uint32_t cy0 = std::max(y0, oy), cy1 = std::min(y1, oy + bh);
            uint32_t cx0 = std::max(x0, ox), cx1 = std::min(x1, ox + bw);
            if (cy0 >= cy1 || cx0 >= cx1) continue;
            for (uint32_t yy = cy0; yy < cy1; yy++) {
                const uint8_t* src = block +
                    ((size_t)(yy - oy) * bw + (cx0 - ox)) * samp_bytes * h->spp;
                DstT* dst = out + (size_t)(yy - y0) * rw + (cx0 - x0);
                if (!convert_dispatch<DstT>(h, src, dst, cx1 - cx0)) return -3;
            }
        }
    }
    return 0;
}

}  // namespace

extern "C" {

void* nyxtiff_open(const char* path) {
    TIFFSetWarningHandler(nullptr);
    TIFF* tif = TIFFOpen(path, "r");
    if (!tif) return nullptr;
    auto* h = new TiffHandle();
    h->tif = tif;
    TIFFGetField(tif, TIFFTAG_IMAGEWIDTH, &h->width);
    TIFFGetField(tif, TIFFTAG_IMAGELENGTH, &h->height);
    TIFFGetFieldDefaulted(tif, TIFFTAG_BITSPERSAMPLE, &h->bits);
    TIFFGetFieldDefaulted(tif, TIFFTAG_SAMPLEFORMAT, &h->sample_format);
    TIFFGetFieldDefaulted(tif, TIFFTAG_SAMPLESPERPIXEL, &h->spp);
    h->tiled = TIFFIsTiled(tif);
    if (h->tiled) {
        TIFFGetField(tif, TIFFTAG_TILEWIDTH, &h->tile_w);
        TIFFGetField(tif, TIFFTAG_TILELENGTH, &h->tile_h);
    } else {
        uint32_t rps = 0;
        TIFFGetFieldDefaulted(tif, TIFFTAG_ROWSPERSTRIP, &rps);
        if (rps == 0 || rps > h->height) rps = h->height;
        h->tile_w = h->width;
        h->tile_h = rps;
    }
    if (h->bits != 8 && h->bits != 16 && h->bits != 32 && h->bits != 64) {
        delete h;
        TIFFClose(tif);
        return nullptr;
    }
    return h;
}

// dims[0..7] = width, height, tile_w, tile_h, tiled, bits, sample_format, spp
int nyxtiff_info(void* vh, uint32_t* dims) {
    auto* h = static_cast<TiffHandle*>(vh);
    if (!h) return -1;
    dims[0] = h->width;
    dims[1] = h->height;
    dims[2] = h->tile_w;
    dims[3] = h->tile_h;
    dims[4] = h->tiled ? 1 : 0;
    dims[5] = h->bits;
    dims[6] = h->sample_format;
    dims[7] = h->spp;
    return 0;
}

int nyxtiff_read_region_f32(void* vh, uint32_t y0, uint32_t x0, uint32_t rh,
                            uint32_t rw, float* out) {
    return read_region_impl<float>(static_cast<TiffHandle*>(vh), y0, x0, rh,
                                   rw, out);
}

int nyxtiff_read_region_f64(void* vh, uint32_t y0, uint32_t x0, uint32_t rh,
                            uint32_t rw, double* out) {
    return read_region_impl<double>(static_cast<TiffHandle*>(vh), y0, x0, rh,
                                    rw, out);
}

int nyxtiff_read_region_u32(void* vh, uint32_t y0, uint32_t x0, uint32_t rh,
                            uint32_t rw, uint32_t* out) {
    return read_region_impl<uint32_t>(static_cast<TiffHandle*>(vh), y0, x0,
                                      rh, rw, out);
}

// Streaming whole-slide prescan: per-slide min/max intensity + nonzero count
// (the reference's SlideProps scan, slideprops.cpp:456 scan_slide_props),
// decoding one tile/strip at a time so RAM stays O(tile).
int nyxtiff_prescan(void* vh, double* minv, double* maxv, int64_t* nonzero) {
    auto* h = static_cast<TiffHandle*>(vh);
    if (!h) return -1;
    double mn = std::numeric_limits<double>::infinity();
    double mx = -std::numeric_limits<double>::infinity();
    int64_t nz = 0;
    std::vector<double> buf;
    uint32_t step_y = h->tile_h, step_x = h->tiled ? h->tile_w : h->width;
    for (uint32_t by = 0; by < h->height; by += step_y) {
        for (uint32_t bx = 0; bx < h->width; bx += step_x) {
            uint32_t oy, ox, bh, bw;
            const uint8_t* block = load_block(h, by, bx, &oy, &ox, &bh, &bw);
            if (!block) return -2;
            uint32_t vh_ = std::min<uint32_t>(bh, h->height - oy);
            uint32_t vw = std::min<uint32_t>(bw, h->width - ox);
            buf.resize((size_t)vw);
            size_t samp_bytes = h->bits / 8;
            for (uint32_t yy = 0; yy < vh_; yy++) {
                const uint8_t* src =
                    block + (size_t)yy * bw * samp_bytes * h->spp;
                if (!convert_dispatch<double>(h, src, buf.data(), vw))
                    return -3;
                for (uint32_t xx = 0; xx < vw; xx++) {
                    double v = buf[xx];
                    if (v < mn) mn = v;
                    if (v > mx) mx = v;
                    if (v != 0.0) nz++;
                }
            }
        }
    }
    *minv = mn;
    *maxv = mx;
    *nonzero = nz;
    return 0;
}

void nyxtiff_close(void* vh) {
    auto* h = static_cast<TiffHandle*>(vh);
    if (h) {
        TIFFClose(h->tif);
        delete h;
    }
}

// Write a grayscale TIFF (test fixtures + synthetic benchmark slides).
//   data: row-major [height, width]; dtype: 1=u8 2=u16 4=u32 16=f32
//   tile_size: 0 = stripped; else tiled with tile_size x tile_size tiles
//   compression: 0 = none, 1 = LZW, 2 = deflate
int nyxtiff_write(const char* path, const void* data, uint32_t height,
                  uint32_t width, int dtype, uint32_t tile_size,
                  int compression) {
    uint16_t bits, fmt;
    switch (dtype) {
        case 1:  bits = 8;  fmt = SAMPLEFORMAT_UINT; break;
        case 2:  bits = 16; fmt = SAMPLEFORMAT_UINT; break;
        case 4:  bits = 32; fmt = SAMPLEFORMAT_UINT; break;
        case 16: bits = 32; fmt = SAMPLEFORMAT_IEEEFP; break;
        default: return -1;
    }
    size_t bpp = bits / 8;
    TIFF* tif = TIFFOpen(path, "w");
    if (!tif) return -2;
    TIFFSetField(tif, TIFFTAG_IMAGEWIDTH, width);
    TIFFSetField(tif, TIFFTAG_IMAGELENGTH, height);
    TIFFSetField(tif, TIFFTAG_BITSPERSAMPLE, bits);
    TIFFSetField(tif, TIFFTAG_SAMPLESPERPIXEL, (uint16_t)1);
    TIFFSetField(tif, TIFFTAG_SAMPLEFORMAT, fmt);
    TIFFSetField(tif, TIFFTAG_PHOTOMETRIC, PHOTOMETRIC_MINISBLACK);
    TIFFSetField(tif, TIFFTAG_PLANARCONFIG, PLANARCONFIG_CONTIG);
    TIFFSetField(tif, TIFFTAG_COMPRESSION,
                 compression == 1 ? COMPRESSION_LZW
                 : compression == 2 ? COMPRESSION_ADOBE_DEFLATE
                                    : COMPRESSION_NONE);
    const uint8_t* src = static_cast<const uint8_t*>(data);
    int rc = 0;
    if (tile_size > 0) {
        TIFFSetField(tif, TIFFTAG_TILEWIDTH, tile_size);
        TIFFSetField(tif, TIFFTAG_TILELENGTH, tile_size);
        std::vector<uint8_t> tile((size_t)tile_size * tile_size * bpp, 0);
        for (uint32_t ty = 0; ty < height && rc == 0; ty += tile_size)
            for (uint32_t tx = 0; tx < width && rc == 0; tx += tile_size) {
                std::fill(tile.begin(), tile.end(), 0);
                uint32_t ch = std::min(tile_size, height - ty);
                uint32_t cw = std::min(tile_size, width - tx);
                for (uint32_t yy = 0; yy < ch; yy++)
                    std::memcpy(tile.data() + (size_t)yy * tile_size * bpp,
                                src + ((size_t)(ty + yy) * width + tx) * bpp,
                                (size_t)cw * bpp);
                if (TIFFWriteTile(tif, tile.data(), tx, ty, 0, 0) < 0) rc = -3;
            }
    } else {
        uint32_t rps = std::max<uint32_t>(1, (1u << 20) / (width * bpp));
        TIFFSetField(tif, TIFFTAG_ROWSPERSTRIP, rps);
        for (uint32_t y = 0; y < height && rc == 0; y += rps) {
            uint32_t ch = std::min(rps, height - y);
            if (TIFFWriteEncodedStrip(
                    tif, y / rps,
                    const_cast<uint8_t*>(src + (size_t)y * width * bpp),
                    (tmsize_t)ch * width * bpp) < 0)
                rc = -3;
        }
    }
    TIFFClose(tif);
    return rc;
}

}  // extern "C"
