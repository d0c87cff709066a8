// DigiPathAI-TPU native slide I/O: libtiff-backed tile reader + pyramid writer.
//
// First-party replacement for the reference's native surface (OpenSlide region
// decode, tifffile writes and the ImageMagick `convert ... ptif:` subprocess;
// see SURVEY.md §2.3). Exposed as a C ABI consumed via ctypes
// (digipathai_tpu_torch/io/native.py); the pure-Python implementation in
// io/tiff_py.py is the behavioral reference.
//
// Concurrency: libtiff handles are not thread-safe, so the reader keeps a
// small pool of TIFF* handles per file; concurrent read_region calls check
// handles out under a mutex and decode in parallel (ctypes releases the GIL).

#include <tiffio.h>
#include <unistd.h>

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <list>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct LevelInfo {
  uint32_t width = 0, height = 0;
  uint32_t tile_w = 0, tile_h = 0;
  uint16_t samples = 1, bits = 8;
  uint16_t compression = 1, photometric = 1;
};

// Decoded-tile LRU: overlapping patch reads (stride < patch) hit each tile
// several times; caching the RGBA decode quarters JPEG work.
struct TileCache {
  using Key = uint64_t;  // (level << 32) | tile_index
  size_t capacity = 64;
  std::list<Key> order;
  std::unordered_map<Key, std::pair<std::list<Key>::iterator,
                                    std::vector<uint32_t>>> map;
  std::mutex mu;

  bool get(Key k, std::vector<uint32_t> &out) {
    std::lock_guard<std::mutex> lk(mu);
    auto it = map.find(k);
    if (it == map.end()) return false;
    order.splice(order.begin(), order, it->second.first);
    out = it->second.second;
    return true;
  }
  void put(Key k, const std::vector<uint32_t> &v) {
    std::lock_guard<std::mutex> lk(mu);
    if (map.count(k)) return;
    order.push_front(k);
    map.emplace(k, std::make_pair(order.begin(), v));
    while (map.size() > capacity) {
      map.erase(order.back());
      order.pop_back();
    }
  }
};

struct Reader {
  std::string path;
  std::vector<LevelInfo> levels;
  std::vector<std::string> level_descriptions;
  std::string description;
  float x_resolution = 0.0f;
  uint16_t resolution_unit = 2;  // 2=inch, 3=cm
  TileCache cache;
  // handle pool
  std::vector<TIFF *> pool;
  std::vector<bool> busy;
  std::mutex mu;
  std::condition_variable cv;
};

TIFF *checkout(Reader *r) {
  std::unique_lock<std::mutex> lk(r->mu);
  for (;;) {
    for (size_t i = 0; i < r->pool.size(); ++i) {
      if (!r->busy[i]) {
        r->busy[i] = true;
        return r->pool[i];
      }
    }
    if (r->pool.size() < 8) {
      TIFF *t = TIFFOpen(r->path.c_str(), "rm");
      if (!t) return nullptr;
      r->pool.push_back(t);
      r->busy.push_back(true);
      return t;
    }
    r->cv.wait(lk);
  }
}

void checkin(Reader *r, TIFF *t) {
  std::lock_guard<std::mutex> lk(r->mu);
  for (size_t i = 0; i < r->pool.size(); ++i) {
    if (r->pool[i] == t) {
      r->busy[i] = false;
      break;
    }
  }
  r->cv.notify_one();
}

}  // namespace

extern "C" {

void *dpai_open(const char *path) {
  TIFF *t = TIFFOpen(path, "rm");
  if (!t) return nullptr;
  auto *r = new Reader();
  r->path = path;
  do {
    LevelInfo li;
    TIFFGetField(t, TIFFTAG_IMAGEWIDTH, &li.width);
    TIFFGetField(t, TIFFTAG_IMAGELENGTH, &li.height);
    TIFFGetField(t, TIFFTAG_TILEWIDTH, &li.tile_w);
    TIFFGetField(t, TIFFTAG_TILELENGTH, &li.tile_h);
    TIFFGetFieldDefaulted(t, TIFFTAG_SAMPLESPERPIXEL, &li.samples);
    TIFFGetFieldDefaulted(t, TIFFTAG_BITSPERSAMPLE, &li.bits);
    TIFFGetFieldDefaulted(t, TIFFTAG_COMPRESSION, &li.compression);
    TIFFGetFieldDefaulted(t, TIFFTAG_PHOTOMETRIC, &li.photometric);
    {
      char *desc = nullptr;
      r->level_descriptions.push_back(
          (TIFFGetField(t, TIFFTAG_IMAGEDESCRIPTION, &desc) && desc)
              ? std::string(desc) : std::string());
    }
    if (r->levels.empty()) {
      r->description = r->level_descriptions[0];
      float xres = 0.0f;
      if (TIFFGetField(t, TIFFTAG_XRESOLUTION, &xres)) r->x_resolution = xres;
      TIFFGetFieldDefaulted(t, TIFFTAG_RESOLUTIONUNIT, &r->resolution_unit);
    }
    r->levels.push_back(li);
  } while (TIFFReadDirectory(t));
  r->pool.push_back(t);
  r->busy.push_back(false);
  return r;
}

// Resize the decoded-tile LRU (entries, not bytes). Evicts down if shrunk.
void dpai_set_cache_size(void *h, uint32_t n) {
  auto *r = static_cast<Reader *>(h);
  std::lock_guard<std::mutex> lk(r->cache.mu);
  r->cache.capacity = n > 0 ? n : 1;
  while (r->cache.map.size() > r->cache.capacity) {
    r->cache.map.erase(r->cache.order.back());
    r->cache.order.pop_back();
  }
}

void dpai_close(void *h) {
  auto *r = static_cast<Reader *>(h);
  for (TIFF *t : r->pool) TIFFClose(t);
  delete r;
}

int dpai_level_count(void *h) {
  return static_cast<int>(static_cast<Reader *>(h)->levels.size());
}

// out: w, h, tile_w, tile_h, samples, bits
int dpai_level_info(void *h, int level, uint32_t *out) {
  auto *r = static_cast<Reader *>(h);
  if (level < 0 || level >= (int)r->levels.size()) return -1;
  const LevelInfo &li = r->levels[level];
  out[0] = li.width;
  out[1] = li.height;
  out[2] = li.tile_w;
  out[3] = li.tile_h;
  out[4] = li.samples;
  out[5] = li.bits;
  return 0;
}

// out: w, h, tile_w, tile_h, samples, bits, compression, photometric
int dpai_level_info2(void *h, int level, uint32_t *out) {
  auto *r = static_cast<Reader *>(h);
  if (level < 0 || level >= (int)r->levels.size()) return -1;
  const LevelInfo &li = r->levels[level];
  out[0] = li.width;
  out[1] = li.height;
  out[2] = li.tile_w;
  out[3] = li.tile_h;
  out[4] = li.samples;
  out[5] = li.bits;
  out[6] = li.compression;
  out[7] = li.photometric;
  return 0;
}

const char *dpai_description(void *h) {
  return static_cast<Reader *>(h)->description.c_str();
}

const char *dpai_level_description(void *h, int level) {
  auto *r = static_cast<Reader *>(h);
  if (level < 0 || level >= (int)r->level_descriptions.size()) return "";
  return r->level_descriptions[level].c_str();
}

void dpai_resolution(void *h, float *xres, int *unit) {
  auto *r = static_cast<Reader *>(h);
  *xres = r->x_resolution;
  *unit = r->resolution_unit;
}

// Reads a (w x h) RGB region at `level` into out (h*w*3 bytes, row-major).
// Out-of-bounds pixels are zero-filled. Uses the RGBA codepath so JPEG/YCbCr
// tiled slides decode correctly.
int dpai_read_region(void *h, int level, int64_t x, int64_t y, uint32_t w,
                     uint32_t h_out, uint8_t *out) {
  auto *r = static_cast<Reader *>(h);
  if (level < 0 || level >= (int)r->levels.size()) return -1;
  const LevelInfo &li = r->levels[level];
  TIFF *t = checkout(r);
  if (!t) return -2;
  if (!TIFFSetDirectory(t, (uint16_t)level)) {
    checkin(r, t);
    return -3;
  }
  std::memset(out, 0, (size_t)w * h_out * 3);

  int rc = 0;
  if (li.tile_w == 0) {  // stripped image: read whole rows via RGBA strips
    uint32_t rps = 0;
    TIFFGetFieldDefaulted(t, TIFFTAG_ROWSPERSTRIP, &rps);
    if (rps == 0 || rps > li.height) rps = li.height;
    std::vector<uint32_t> strip((size_t)li.width * rps);
    int64_t y0 = y < 0 ? 0 : y;
    int64_t y1 = std::min<int64_t>(y + h_out, li.height);
    for (int64_t sy = (y0 / rps) * rps; sy < y1; sy += rps) {
      if (!TIFFReadRGBAStrip(t, (uint32_t)sy, strip.data())) {
        rc = -4;
        break;
      }
      uint32_t sh = std::min<uint32_t>(rps, li.height - (uint32_t)sy);
      // RGBA strips are bottom-up within the strip
      for (uint32_t row = 0; row < sh; ++row) {
        int64_t gy = sy + row;
        if (gy < y || gy >= y + (int64_t)h_out || gy >= (int64_t)li.height)
          continue;
        const uint32_t *src = strip.data() + (size_t)(sh - 1 - row) * li.width;
        int64_t gx0 = x < 0 ? 0 : x;
        int64_t gx1 = std::min<int64_t>(x + w, li.width);
        uint8_t *dst = out + ((size_t)(gy - y) * w + (gx0 - x)) * 3;
        for (int64_t gx = gx0; gx < gx1; ++gx) {
          uint32_t px = src[gx];
          dst[0] = TIFFGetR(px);
          dst[1] = TIFFGetG(px);
          dst[2] = TIFFGetB(px);
          dst += 3;
        }
      }
    }
  } else {
    std::vector<uint32_t> tile((size_t)li.tile_w * li.tile_h);
    uint32_t tiles_across = (li.width + li.tile_w - 1) / li.tile_w;
    int64_t tx0 = std::max<int64_t>(0, x) / li.tile_w;
    int64_t ty0 = std::max<int64_t>(0, y) / li.tile_h;
    int64_t tx1 = std::min<int64_t>(li.width - 1, x + w - 1) / li.tile_w;
    int64_t ty1 = std::min<int64_t>(li.height - 1, y + h_out - 1) / li.tile_h;
    for (int64_t ty = ty0; ty <= ty1 && rc == 0; ++ty) {
      for (int64_t tx = tx0; tx <= tx1; ++tx) {
        uint64_t key = ((uint64_t)level << 32) |
                       (uint64_t)(ty * tiles_across + tx);
        if (!r->cache.get(key, tile)) {
          if (!TIFFReadRGBATile(t, (uint32_t)(tx * li.tile_w),
                                (uint32_t)(ty * li.tile_h), tile.data())) {
            rc = -4;
            break;
          }
          r->cache.put(key, tile);
        }
        int64_t px0 = std::max<int64_t>(x, tx * li.tile_w);
        int64_t py0 = std::max<int64_t>(y, ty * li.tile_h);
        int64_t px1 = std::min<int64_t>(x + w, (tx + 1) * li.tile_w);
        int64_t py1 = std::min<int64_t>(y + h_out, (ty + 1) * li.tile_h);
        px1 = std::min<int64_t>(px1, li.width);
        py1 = std::min<int64_t>(py1, li.height);
        for (int64_t gy = py0; gy < py1; ++gy) {
          // RGBA tiles are bottom-up
          uint32_t row_in_tile = (uint32_t)(gy - ty * li.tile_h);
          const uint32_t *src =
              tile.data() + (size_t)(li.tile_h - 1 - row_in_tile) * li.tile_w +
              (px0 - tx * li.tile_w);
          uint8_t *dst = out + ((size_t)(gy - y) * w + (px0 - x)) * 3;
          for (int64_t gx = px0; gx < px1; ++gx) {
            uint32_t px = *src++;
            dst[0] = TIFFGetR(px);
            dst[1] = TIFFGetG(px);
            dst[2] = TIFFGetB(px);
            dst += 3;
          }
        }
      }
    }
  }
  checkin(r, t);
  return rc;
}

// ---------------------------------------------------------------------------
// Pyramid writer: tiled multi-directory TIFF, 2x2 mean downsample chain.
// compression: 1=none, 5=lzw, 7=jpeg, 8=deflate.
// ---------------------------------------------------------------------------
// Streaming pyramid writer: the caller feeds level-0 rows in blocks; tiles
// are emitted per 256-row strip and the 2x2-mean downsample cascades into a
// disk scratch file per level, so peak RAM is one strip (width x tile x C)
// regardless of image size.  This is what lets >1 GP maps use the native
// path (the in-RAM dpai_write_pyramid below keeps the whole level chain
// resident).  Mirrors tiff_py.PyramidalTiffWriter's write_base streaming.

namespace {

struct StreamWriter {
  TIFF *tif = nullptr;
  std::string path, scratch_path;
  uint64_t width = 0, height = 0;
  int channels = 1, tile = 256, compression = 7, quality = 90;
  std::vector<uint8_t> strip;   // (tile, width, C) rolling buffer
  uint32_t filled = 0;          // valid rows in `strip`
  uint64_t row = 0;             // next absolute level-0 row
  FILE *scratch = nullptr;      // level-1 raw stream
  bool failed = false;

  size_t row_bytes() const { return (size_t)width * channels; }
};

void set_level_fields(TIFF *t, uint64_t w, uint64_t h, int channels, int tile,
                      int compression, int quality, const char *description,
                      double mpp, bool level0) {
  TIFFSetField(t, TIFFTAG_IMAGEWIDTH, (uint32_t)w);
  TIFFSetField(t, TIFFTAG_IMAGELENGTH, (uint32_t)h);
  TIFFSetField(t, TIFFTAG_BITSPERSAMPLE, 8);
  TIFFSetField(t, TIFFTAG_SAMPLESPERPIXEL, channels);
  TIFFSetField(t, TIFFTAG_PLANARCONFIG, PLANARCONFIG_CONTIG);
  TIFFSetField(t, TIFFTAG_TILEWIDTH, (uint32_t)tile);
  TIFFSetField(t, TIFFTAG_TILELENGTH, (uint32_t)tile);
  TIFFSetField(t, TIFFTAG_COMPRESSION, (uint16_t)compression);
  if (compression == COMPRESSION_JPEG) {
    TIFFSetField(t, TIFFTAG_JPEGQUALITY, quality);
    TIFFSetField(t, TIFFTAG_PHOTOMETRIC,
                 channels == 3 ? PHOTOMETRIC_YCBCR : PHOTOMETRIC_MINISBLACK);
    if (channels == 3) TIFFSetField(t, TIFFTAG_JPEGCOLORMODE, JPEGCOLORMODE_RGB);
  } else {
    TIFFSetField(t, TIFFTAG_PHOTOMETRIC,
                 channels == 3 ? PHOTOMETRIC_RGB : PHOTOMETRIC_MINISBLACK);
  }
  if (level0) {
    std::string desc = description ? description : "";
    if (mpp > 0) {
      if (!desc.empty()) desc += "|";
      desc += "mpp=" + std::to_string(mpp);
      TIFFSetField(t, TIFFTAG_RESOLUTIONUNIT, RESUNIT_CENTIMETER);
      TIFFSetField(t, TIFFTAG_XRESOLUTION, (float)(10000.0 / mpp));
      TIFFSetField(t, TIFFTAG_YRESOLUTION, (float)(10000.0 / mpp));
    }
    if (!desc.empty()) TIFFSetField(t, TIFFTAG_IMAGEDESCRIPTION, desc.c_str());
  } else {
    TIFFSetField(t, TIFFTAG_SUBFILETYPE, FILETYPE_REDUCEDIMAGE);
  }
}

// Emit one strip (sw.filled rows starting at absolute row `y0`) as tiles.
int emit_strip(TIFF *t, const uint8_t *strip, uint64_t w, uint32_t filled,
               uint64_t y0, int channels, int tile, bool jpeg_pad,
               std::vector<uint8_t> &tbuf) {
  for (uint64_t tx = 0; tx < w; tx += tile) {
    uint32_t bw = (uint32_t)std::min<uint64_t>(tile, w - tx);
    std::memset(tbuf.data(), 0, tbuf.size());
    for (uint32_t yy = 0; yy < filled; ++yy)
      std::memcpy(tbuf.data() + (size_t)yy * tile * channels,
                  strip + ((size_t)yy * w + tx) * channels,
                  (size_t)bw * channels);
    if (jpeg_pad) {  // replicate edges so JPEG padding doesn't bleed dark
      for (uint32_t yy = 0; yy < filled; ++yy)
        for (uint32_t xx = bw; xx < (uint32_t)tile; ++xx)
          std::memcpy(tbuf.data() + ((size_t)yy * tile + xx) * channels,
                      tbuf.data() + ((size_t)yy * tile + bw - 1) * channels,
                      channels);
      for (uint32_t yy = filled; yy < (uint32_t)tile; ++yy)
        std::memcpy(tbuf.data() + (size_t)yy * tile * channels,
                    tbuf.data() + (size_t)(filled - 1) * tile * channels,
                    (size_t)tile * channels);
    }
    if (TIFFWriteTile(t, tbuf.data(), (uint32_t)tx, (uint32_t)y0, 0, 0) < 0)
      return -3;
  }
  return 0;
}

// Downsample `filled` rows of width w into floor(filled/2) rows of width
// max(1, w/2), appending to `out` (x-odd edge clamped).
void downsample_strip(const uint8_t *strip, uint64_t w, uint32_t filled,
                      int channels, FILE *out, std::vector<uint8_t> &rowbuf) {
  uint64_t nw = std::max<uint64_t>(1, w / 2);
  rowbuf.resize((size_t)nw * channels);
  for (uint32_t yy = 0; yy + 1 < filled || (filled == 1 && yy == 0); yy += 2) {
    const uint8_t *r0 = strip + (size_t)yy * w * channels;
    const uint8_t *r1 = (yy + 1 < filled) ? r0 + (size_t)w * channels : r0;
    for (uint64_t xx = 0; xx < nw; ++xx) {
      uint64_t x1 = std::min<uint64_t>(2 * xx + 1, w - 1);
      for (int c = 0; c < channels; ++c) {
        uint32_t sum = r0[2 * xx * channels + c] + r0[x1 * channels + c] +
                       r1[2 * xx * channels + c] + r1[x1 * channels + c];
        rowbuf[(size_t)xx * channels + c] = (uint8_t)((sum + 2) / 4);
      }
    }
    fwrite(rowbuf.data(), 1, rowbuf.size(), out);
    if (filled == 1) break;
  }
}

}  // namespace

void *dpai_writer_open(const char *path, uint64_t width, uint64_t height,
                       int channels, int tile, int compression, int quality,
                       const char *description, double mpp) {
  if (channels != 1 && channels != 3) return nullptr;
  bool big = (width * height * (uint64_t)channels) > (2ull << 30);
  TIFF *t = TIFFOpen(path, big ? "w8" : "w");
  if (!t) return nullptr;
  auto *sw = new StreamWriter();
  sw->tif = t;
  sw->path = path;
  sw->scratch_path = std::string(path) + ".lvl.tmp";
  sw->width = width;
  sw->height = height;
  sw->channels = channels;
  sw->tile = tile;
  sw->compression = compression;
  sw->quality = quality;
  sw->strip.resize((size_t)tile * width * channels);
  sw->scratch = fopen(sw->scratch_path.c_str(), "wb");
  if (!sw->scratch) {
    TIFFClose(t);
    delete sw;
    return nullptr;
  }
  set_level_fields(t, width, height, channels, tile, compression, quality,
                   description, mpp, true);
  return sw;
}

int dpai_writer_write_rows(void *h, const uint8_t *rows, uint32_t n_rows) {
  auto *sw = static_cast<StreamWriter *>(h);
  if (sw->failed) return -1;
  std::vector<uint8_t> tbuf((size_t)sw->tile * sw->tile * sw->channels);
  std::vector<uint8_t> rowbuf;
  while (n_rows > 0) {
    uint32_t take = std::min<uint32_t>(n_rows, sw->tile - sw->filled);
    std::memcpy(sw->strip.data() + (size_t)sw->filled * sw->row_bytes(),
                rows, (size_t)take * sw->row_bytes());
    rows += (size_t)take * sw->row_bytes();
    sw->filled += take;
    n_rows -= take;
    if (sw->filled == (uint32_t)sw->tile) {
      uint64_t y0 = sw->row;
      int rc = emit_strip(sw->tif, sw->strip.data(), sw->width, sw->filled,
                          y0, sw->channels, sw->tile,
                          sw->compression == COMPRESSION_JPEG, tbuf);
      if (rc != 0) {
        sw->failed = true;
        return rc;
      }
      downsample_strip(sw->strip.data(), sw->width, sw->filled, sw->channels,
                       sw->scratch, rowbuf);
      sw->row += sw->filled;
      sw->filled = 0;
    }
  }
  return 0;
}

int dpai_writer_close(void *h) {
  auto *sw = static_cast<StreamWriter *>(h);
  TIFF *t = sw->tif;
  int rc = 0;
  std::vector<uint8_t> tbuf((size_t)sw->tile * sw->tile * sw->channels);
  std::vector<uint8_t> rowbuf;
  if (!sw->failed && sw->filled > 0) {  // final partial strip
    rc = emit_strip(t, sw->strip.data(), sw->width, sw->filled, sw->row,
                    sw->channels, sw->tile,
                    sw->compression == COMPRESSION_JPEG, tbuf);
    if (rc == 0)
      downsample_strip(sw->strip.data(), sw->width, sw->filled, sw->channels,
                       sw->scratch, rowbuf);
  }
  fclose(sw->scratch);
  sw->scratch = nullptr;
  if (rc == 0 && !sw->failed && !TIFFWriteDirectory(t)) rc = -4;

  // Remaining levels: stream each from the scratch raw file, emitting tiles
  // and cascading the next scratch, with one strip of RAM per pass.
  uint64_t w = std::max<uint64_t>(1, sw->width / 2);
  uint64_t hh = std::max<uint64_t>(1, sw->height / 2);
  std::string cur = sw->scratch_path;
  bool more = rc == 0 && !sw->failed &&
              std::max(sw->width, sw->height) > (uint64_t)sw->tile;
  while (more) {
    FILE *in = fopen(cur.c_str(), "rb");
    if (!in) {
      rc = -5;
      break;
    }
    bool last = std::max(w, hh) <= (uint64_t)sw->tile;
    std::string next_path = cur + "x";
    FILE *next = last ? nullptr : fopen(next_path.c_str(), "wb");
    set_level_fields(t, w, hh, sw->channels, sw->tile, sw->compression,
                     sw->quality, nullptr, 0.0, false);
    std::vector<uint8_t> strip((size_t)sw->tile * w * sw->channels);
    for (uint64_t y0 = 0; y0 < hh && rc == 0; y0 += sw->tile) {
      uint32_t sh = (uint32_t)std::min<uint64_t>(sw->tile, hh - y0);
      if (fread(strip.data(), 1, (size_t)sh * w * sw->channels, in) !=
          (size_t)sh * w * sw->channels) {
        rc = -6;
        break;
      }
      rc = emit_strip(t, strip.data(), w, sh, y0, sw->channels, sw->tile,
                      sw->compression == COMPRESSION_JPEG, tbuf);
      if (rc == 0 && next)
        downsample_strip(strip.data(), w, sh, sw->channels, next, rowbuf);
    }
    fclose(in);
    if (next) fclose(next);
    unlink(cur.c_str());
    cur = next_path;
    if (rc == 0 && !TIFFWriteDirectory(t)) rc = -4;
    if (last || rc != 0) break;
    w = std::max<uint64_t>(1, w / 2);
    hh = std::max<uint64_t>(1, hh / 2);
  }
  if (more && !cur.empty()) unlink(cur.c_str());
  if (!more) unlink(sw->scratch_path.c_str());
  TIFFClose(t);
  delete sw;
  return rc;
}

int dpai_write_pyramid(const char *path, const uint8_t *base, uint64_t width,
                       uint64_t height, int channels, int tile,
                       int compression, int quality, const char *description,
                       double mpp) {
  if (channels != 1 && channels != 3) return -1;
  bool big = (width * height * (uint64_t)channels) > (2ull << 30);
  TIFF *t = TIFFOpen(path, big ? "w8" : "w");
  if (!t) return -2;

  // build the level chain (level 0 borrows `base`)
  std::vector<std::vector<uint8_t>> owned;
  std::vector<const uint8_t *> ptrs;
  std::vector<std::pair<uint64_t, uint64_t>> dims;
  ptrs.push_back(base);
  dims.push_back({width, height});
  while (std::max(dims.back().first, dims.back().second) > (uint64_t)tile) {
    uint64_t w = dims.back().first, h = dims.back().second;
    uint64_t nw = std::max<uint64_t>(1, w / 2), nh = std::max<uint64_t>(1, h / 2);
    const uint8_t *src = ptrs.back();
    owned.emplace_back((size_t)nw * nh * channels);
    uint8_t *dst = owned.back().data();
    for (uint64_t yy = 0; yy < nh; ++yy) {
      const uint8_t *r0 = src + (2 * yy) * w * channels;
      const uint8_t *r1 =
          src + std::min<uint64_t>(2 * yy + 1, h - 1) * w * channels;
      for (uint64_t xx = 0; xx < nw; ++xx) {
        uint64_t x1 = std::min<uint64_t>(2 * xx + 1, w - 1);
        for (int c = 0; c < channels; ++c) {
          uint32_t sum = r0[2 * xx * channels + c] + r0[x1 * channels + c] +
                         r1[2 * xx * channels + c] + r1[x1 * channels + c];
          dst[(yy * nw + xx) * channels + c] = (uint8_t)((sum + 2) / 4);
        }
      }
    }
    ptrs.push_back(owned.back().data());
    dims.push_back({nw, nh});
  }

  std::vector<uint8_t> tbuf((size_t)tile * tile * channels);
  for (size_t lvl = 0; lvl < ptrs.size(); ++lvl) {
    uint64_t w = dims[lvl].first, h = dims[lvl].second;
    TIFFSetField(t, TIFFTAG_IMAGEWIDTH, (uint32_t)w);
    TIFFSetField(t, TIFFTAG_IMAGELENGTH, (uint32_t)h);
    TIFFSetField(t, TIFFTAG_BITSPERSAMPLE, 8);
    TIFFSetField(t, TIFFTAG_SAMPLESPERPIXEL, channels);
    TIFFSetField(t, TIFFTAG_PLANARCONFIG, PLANARCONFIG_CONTIG);
    TIFFSetField(t, TIFFTAG_TILEWIDTH, (uint32_t)tile);
    TIFFSetField(t, TIFFTAG_TILELENGTH, (uint32_t)tile);
    TIFFSetField(t, TIFFTAG_COMPRESSION, (uint16_t)compression);
    if (compression == COMPRESSION_JPEG) {
      TIFFSetField(t, TIFFTAG_JPEGQUALITY, quality);
      TIFFSetField(t, TIFFTAG_PHOTOMETRIC,
                   channels == 3 ? PHOTOMETRIC_YCBCR : PHOTOMETRIC_MINISBLACK);
      if (channels == 3) TIFFSetField(t, TIFFTAG_JPEGCOLORMODE, JPEGCOLORMODE_RGB);
    } else {
      TIFFSetField(t, TIFFTAG_PHOTOMETRIC,
                   channels == 3 ? PHOTOMETRIC_RGB : PHOTOMETRIC_MINISBLACK);
    }
    if (lvl == 0) {
      std::string desc = description ? description : "";
      if (mpp > 0) {
        if (!desc.empty()) desc += "|";
        desc += "mpp=" + std::to_string(mpp);
        TIFFSetField(t, TIFFTAG_RESOLUTIONUNIT, RESUNIT_CENTIMETER);
        TIFFSetField(t, TIFFTAG_XRESOLUTION, (float)(10000.0 / mpp));
        TIFFSetField(t, TIFFTAG_YRESOLUTION, (float)(10000.0 / mpp));
      }
      if (!desc.empty())
        TIFFSetField(t, TIFFTAG_IMAGEDESCRIPTION, desc.c_str());
    } else {
      TIFFSetField(t, TIFFTAG_SUBFILETYPE, FILETYPE_REDUCEDIMAGE);
    }
    const uint8_t *src = ptrs[lvl];
    for (uint64_t ty = 0; ty < h; ty += tile) {
      for (uint64_t tx = 0; tx < w; tx += tile) {
        uint32_t bh = (uint32_t)std::min<uint64_t>(tile, h - ty);
        uint32_t bw = (uint32_t)std::min<uint64_t>(tile, w - tx);
        std::memset(tbuf.data(), 0, tbuf.size());
        for (uint32_t yy = 0; yy < bh; ++yy)
          std::memcpy(tbuf.data() + (size_t)yy * tile * channels,
                      src + ((ty + yy) * w + tx) * channels,
                      (size_t)bw * channels);
        // replicate edges so JPEG padding doesn't bleed dark
        for (uint32_t yy = 0; yy < bh; ++yy)
          for (uint32_t xx = bw; xx < (uint32_t)tile; ++xx)
            std::memcpy(tbuf.data() + ((size_t)yy * tile + xx) * channels,
                        tbuf.data() + ((size_t)yy * tile + bw - 1) * channels,
                        channels);
        for (uint32_t yy = bh; yy < (uint32_t)tile; ++yy)
          std::memcpy(tbuf.data() + (size_t)yy * tile * channels,
                      tbuf.data() + (size_t)(bh - 1) * tile * channels,
                      (size_t)tile * channels);
        if (TIFFWriteTile(t, tbuf.data(), (uint32_t)tx, (uint32_t)ty, 0, 0) < 0) {
          TIFFClose(t);
          return -3;
        }
      }
    }
    if (!TIFFWriteDirectory(t)) {
      TIFFClose(t);
      return -4;
    }
  }
  TIFFClose(t);
  return 0;
}

}  // extern "C"
