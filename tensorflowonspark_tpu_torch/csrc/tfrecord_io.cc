// TFRecord bulk IO — the native hot path for TPU-host data ingest.
//
// The reference delegated TFRecord IO to a prebuilt Hadoop InputFormat jar
// (the reference's lib/tensorflow-hadoop-1.0-SNAPSHOT.jar, driven by
// dfutil.py:39,63); its actual record codec lived in TensorFlow's C++ core
// (tensorflow/core/lib/io/record_reader.cc). This is the TPU-native
// equivalent: a dependency-free C++ reader/writer for the TFRecord framing
// (8-byte LE length, masked-crc32c of the length, payload, masked-crc32c of
// the payload) exposed through a plain C ABI so Python binds it with ctypes
// (no pybind11 in this environment).
//
// Bulk contract: one call loads/indexes a whole shard file. The Python side
// then slices records out of a single contiguous buffer — one FFI round trip
// per file instead of per record, which is what makes feeding a TPU host at
// ResNet rates possible from Python.
//
// Build: `make` in this directory (produces libtfrecord_io.so); loaded by
// tensorflowonspark_tpu/native_io.py, which falls back to the pure-Python
// codec in tensorflowonspark_tpu/tfrecord.py when the library is absent.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

// ---------------------------------------------------------------------------
// crc32c (Castagnoli), slicing-by-8: table-driven, no SSE4.2 dependency so
// the same source builds on any TPU-host CPU image.
// ---------------------------------------------------------------------------

uint32_t kCrcTable[8][256];

// Eager, synchronized table build: ctypes releases the GIL, so two threads
// (e.g. two ImagePipeline producers) may enter tfr_load concurrently — a lazy
// unsynchronized flag would race. Running once at library load removes the
// window entirely.
int crc_init() {
  const uint32_t poly = 0x82f63b78u;  // reflected CRC-32C polynomial
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t crc = i;
    for (int j = 0; j < 8; j++) crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
    kCrcTable[0][i] = crc;
  }
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t crc = kCrcTable[0][i];
    for (int t = 1; t < 8; t++) {
      crc = (crc >> 8) ^ kCrcTable[0][crc & 0xff];
      kCrcTable[t][i] = crc;
    }
  }
  return 0;
}

const int kCrcInitToken = crc_init();  // static initializer, pre-main

uint32_t crc32c(const uint8_t* data, size_t n) {
  uint32_t crc = 0xffffffffu;
  while (n >= 8) {
    uint64_t word;
    memcpy(&word, data, 8);
    word ^= crc;  // little-endian host assumed (x86/arm TPU hosts)
    crc = kCrcTable[7][word & 0xff] ^ kCrcTable[6][(word >> 8) & 0xff] ^
          kCrcTable[5][(word >> 16) & 0xff] ^ kCrcTable[4][(word >> 24) & 0xff] ^
          kCrcTable[3][(word >> 32) & 0xff] ^ kCrcTable[2][(word >> 40) & 0xff] ^
          kCrcTable[1][(word >> 48) & 0xff] ^ kCrcTable[0][(word >> 56) & 0xff];
    data += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ kCrcTable[0][(crc ^ *data++) & 0xff];
  return crc ^ 0xffffffffu;
}

const uint32_t kMaskDelta = 0xa282ead8u;

uint32_t masked_crc(const uint8_t* data, size_t n) {
  uint32_t crc = crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + kMaskDelta;
}

uint32_t read_u32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

uint64_t read_u64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// A fully-loaded shard: the raw file bytes plus an index of payload spans.
struct TfrFile {
  uint8_t* buf;        // whole file
  uint64_t buf_len;
  uint64_t* offsets;   // payload start offsets into buf
  uint64_t* lengths;   // payload lengths
  uint64_t count;      // number of records
};

// Load + index + (optionally) CRC-verify a TFRecord file in one call.
// Returns NULL on IO/corruption error (error text via tfr_last_error).
static thread_local char g_err[256];

const char* tfr_last_error() { return g_err; }

static void set_err(const char* fmt, const char* a, uint64_t b) {
  snprintf(g_err, sizeof(g_err), fmt, a, (unsigned long long)b);
}

void tfr_free(TfrFile* f) {
  if (!f) return;
  free(f->buf);
  free(f->offsets);
  free(f->lengths);
  free(f);
}

TfrFile* tfr_load(const char* path, int verify_crc) {
  g_err[0] = 0;
  FILE* fp = fopen(path, "rb");
  if (!fp) {
    set_err("cannot open %s (record %llu)", path, 0);
    return nullptr;
  }
  fseek(fp, 0, SEEK_END);
  long sz = ftell(fp);
  fseek(fp, 0, SEEK_SET);
  uint8_t* buf = (uint8_t*)malloc(sz > 0 ? sz : 1);
  if (!buf || (sz > 0 && fread(buf, 1, sz, fp) != (size_t)sz)) {
    set_err("short read on %s (record %llu)", path, 0);
    free(buf);
    fclose(fp);
    return nullptr;
  }
  fclose(fp);

  uint64_t cap = 1024, count = 0;
  uint64_t* offsets = (uint64_t*)malloc(cap * sizeof(uint64_t));
  uint64_t* lengths = (uint64_t*)malloc(cap * sizeof(uint64_t));
  if (!offsets || !lengths) {
    set_err("out of memory allocating record index for %s (record %llu)", path, 0);
    free(buf);
    free(offsets);
    free(lengths);
    return nullptr;
  }
  uint64_t pos = 0, n = (uint64_t)sz;
  while (pos < n) {
    if (pos + 12 > n) {
      set_err("truncated length header in %s (record %llu)", path, count);
      goto fail;
    }
    {
      uint64_t len = read_u64(buf + pos);
      uint32_t len_crc = read_u32(buf + pos + 8);
      if (verify_crc && masked_crc(buf + pos, 8) != len_crc) {
        set_err("corrupt length crc in %s (record %llu)", path, count);
        goto fail;
      }
      // overflow-safe: `pos + 12 + len + 4 > n` wraps for a corrupt huge
      // len; compare against the remaining bytes instead
      uint64_t remaining = n - pos;  // >= 12 per the header check above
      if (remaining < 16 || len > remaining - 16) {
        set_err("truncated payload in %s (record %llu)", path, count);
        goto fail;
      }
      if (verify_crc &&
          masked_crc(buf + pos + 12, len) != read_u32(buf + pos + 12 + len)) {
        set_err("corrupt payload crc in %s (record %llu)", path, count);
        goto fail;
      }
      if (count == cap) {
        cap *= 2;
        uint64_t* new_offsets = (uint64_t*)realloc(offsets, cap * sizeof(uint64_t));
        uint64_t* new_lengths = (uint64_t*)realloc(lengths, cap * sizeof(uint64_t));
        if (new_offsets) offsets = new_offsets;
        if (new_lengths) lengths = new_lengths;
        if (!new_offsets || !new_lengths) {
          set_err("out of memory growing record index for %s (record %llu)",
                  path, count);
          goto fail;
        }
      }
      offsets[count] = pos + 12;
      lengths[count] = len;
      count++;
      pos += 12 + len + 4;
    }
  }
  {
    TfrFile* f = (TfrFile*)malloc(sizeof(TfrFile));
    if (!f) {
      set_err("out of memory for handle on %s (record %llu)", path, count);
      goto fail;
    }
    f->buf = buf;
    f->buf_len = n;
    f->offsets = offsets;
    f->lengths = lengths;
    f->count = count;
    return f;
  }
fail:
  free(buf);
  free(offsets);
  free(lengths);
  return nullptr;
}

uint64_t tfr_count(const TfrFile* f) { return f->count; }
const uint8_t* tfr_buffer(const TfrFile* f) { return f->buf; }
uint64_t tfr_buffer_len(const TfrFile* f) { return f->buf_len; }
const uint64_t* tfr_offsets(const TfrFile* f) { return f->offsets; }
const uint64_t* tfr_lengths(const TfrFile* f) { return f->lengths; }

// ---------------------------------------------------------------------------
// Streaming reader: open once, pull bounded chunks. The chunked twin of
// tfr_load for the pipelined input path — a shard no longer has to be fully
// materialized before the first record flows, and the Python side bounds
// peak memory at (chunk records) instead of (shard records). Each chunk is
// returned as a TfrFile (same contiguous buffer + span index contract as
// tfr_load; freed with tfr_free), so the binding slices records identically
// in both modes.
// ---------------------------------------------------------------------------

struct TfrStream {
  FILE* fp;
  int verify_crc;
  uint64_t record_index;  // records consumed so far (error messages)
  char* path;             // owned copy for error messages
};

TfrStream* tfr_stream_open(const char* path, int verify_crc) {
  g_err[0] = 0;
  FILE* fp = fopen(path, "rb");
  if (!fp) {
    set_err("cannot open %s (record %llu)", path, 0);
    return nullptr;
  }
  TfrStream* s = (TfrStream*)malloc(sizeof(TfrStream));
  char* path_copy = (char*)malloc(strlen(path) + 1);
  if (!s || !path_copy) {
    set_err("out of memory opening stream on %s (record %llu)", path, 0);
    free(s);
    free(path_copy);
    fclose(fp);
    return nullptr;
  }
  strcpy(path_copy, path);
  s->fp = fp;
  s->verify_crc = verify_crc;
  s->record_index = 0;
  s->path = path_copy;
  return s;
}

void tfr_stream_close(TfrStream* s) {
  if (!s) return;
  if (s->fp) fclose(s->fp);
  free(s->path);
  free(s);
}

// Read up to max_records sequentially from the stream position. Returns a
// TfrFile chunk, or NULL at clean EOF (tfr_last_error empty) or on error
// (tfr_last_error set). A short chunk is only returned at end of file.
TfrFile* tfr_stream_next(TfrStream* s, uint64_t max_records) {
  g_err[0] = 0;
  if (!s || !s->fp || max_records == 0) return nullptr;
  uint64_t buf_cap = 1 << 20, buf_len = 0;
  uint64_t idx_cap = max_records < 1024 ? max_records : 1024;
  uint64_t count = 0;
  uint8_t* buf = (uint8_t*)malloc(buf_cap);
  uint64_t* offsets = (uint64_t*)malloc(idx_cap * sizeof(uint64_t));
  uint64_t* lengths = (uint64_t*)malloc(idx_cap * sizeof(uint64_t));
  if (!buf || !offsets || !lengths) {
    set_err("out of memory for chunk on %s (record %llu)", s->path,
            s->record_index);
    goto fail;
  }
  while (count < max_records) {
    uint8_t header[12];
    size_t got = fread(header, 1, 12, s->fp);
    if (got == 0) break;  // clean EOF at a record boundary
    if (got != 12) {
      set_err("truncated length header in %s (record %llu)", s->path,
              s->record_index);
      goto fail;
    }
    {
      uint64_t len = read_u64(header);
      uint32_t len_crc = read_u32(header + 8);
      if (s->verify_crc && masked_crc(header, 8) != len_crc) {
        set_err("corrupt length crc in %s (record %llu)", s->path,
                s->record_index);
        goto fail;
      }
      // reject a corrupt huge len before trying to allocate it: the payload
      // plus its crc cannot exceed what is left of the file
      long cur = ftell(s->fp);
      fseek(s->fp, 0, SEEK_END);
      long end = ftell(s->fp);
      fseek(s->fp, cur, SEEK_SET);
      if (end < cur || len > (uint64_t)(end - cur) ||
          (uint64_t)(end - cur) - len < 4) {
        set_err("truncated payload in %s (record %llu)", s->path,
                s->record_index);
        goto fail;
      }
      while (buf_len + len > buf_cap) {
        buf_cap *= 2;
        uint8_t* new_buf = (uint8_t*)realloc(buf, buf_cap);
        if (!new_buf) {
          set_err("out of memory growing chunk on %s (record %llu)", s->path,
                  s->record_index);
          goto fail;
        }
        buf = new_buf;
      }
      uint8_t crc_bytes[4];
      if (fread(buf + buf_len, 1, len, s->fp) != len ||
          fread(crc_bytes, 1, 4, s->fp) != 4) {
        set_err("truncated payload in %s (record %llu)", s->path,
                s->record_index);
        goto fail;
      }
      if (s->verify_crc &&
          masked_crc(buf + buf_len, len) != read_u32(crc_bytes)) {
        set_err("corrupt payload crc in %s (record %llu)", s->path,
                s->record_index);
        goto fail;
      }
      if (count == idx_cap) {
        idx_cap *= 2;
        uint64_t* new_offsets =
            (uint64_t*)realloc(offsets, idx_cap * sizeof(uint64_t));
        uint64_t* new_lengths =
            (uint64_t*)realloc(lengths, idx_cap * sizeof(uint64_t));
        if (new_offsets) offsets = new_offsets;
        if (new_lengths) lengths = new_lengths;
        if (!new_offsets || !new_lengths) {
          set_err("out of memory growing chunk index on %s (record %llu)",
                  s->path, s->record_index);
          goto fail;
        }
      }
      offsets[count] = buf_len;
      lengths[count] = len;
      buf_len += len;
      count++;
      s->record_index++;
    }
  }
  if (count == 0) {  // clean EOF with nothing read
    free(buf);
    free(offsets);
    free(lengths);
    return nullptr;
  }
  {
    TfrFile* f = (TfrFile*)malloc(sizeof(TfrFile));
    if (!f) {
      set_err("out of memory for chunk handle on %s (record %llu)", s->path,
              s->record_index);
      goto fail;
    }
    f->buf = buf;
    f->buf_len = buf_len;
    f->offsets = offsets;
    f->lengths = lengths;
    f->count = count;
    return f;
  }
fail:
  free(buf);
  free(offsets);
  free(lengths);
  return nullptr;
}

// ---------------------------------------------------------------------------
// Writer: frame `count` records (concatenated in `payloads`, spans given by
// offsets/lengths) into `path` in one call.
// ---------------------------------------------------------------------------

int tfr_write(const char* path, const uint8_t* payloads, const uint64_t* offsets,
              const uint64_t* lengths, uint64_t count) {
  g_err[0] = 0;
  FILE* fp = fopen(path, "wb");
  if (!fp) {
    set_err("cannot open %s for write (record %llu)", path, 0);
    return -1;
  }
  for (uint64_t i = 0; i < count; i++) {
    uint8_t header[12];
    uint64_t len = lengths[i];
    memcpy(header, &len, 8);
    uint32_t hcrc = masked_crc(header, 8);
    memcpy(header + 8, &hcrc, 4);
    uint32_t pcrc = masked_crc(payloads + offsets[i], len);
    if (fwrite(header, 1, 12, fp) != 12 ||
        fwrite(payloads + offsets[i], 1, len, fp) != len ||
        fwrite(&pcrc, 1, 4, fp) != 4) {
      set_err("short write on %s (record %llu)", path, i);
      fclose(fp);
      return -1;
    }
  }
  if (fclose(fp) != 0) {
    set_err("close failed on %s (record %llu)", path, count);
    return -1;
  }
  return 0;
}

// Standalone crc for tests / cross-validation with the Python codec.
uint32_t tfr_masked_crc32c(const uint8_t* data, uint64_t n) {
  return masked_crc(data, n);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Baseline JPEG decode + Pillow-exact crop/resize, straight into a caller
// buffer (a shared-memory slab slot). Two decode backends behind one entry
// point:
//
//   * TFR_USE_LIBJPEG (set by the Makefile when jpeglib.h is present): the
//     system libjpeg-turbo — SIMD Huffman/IDCT/upsample/color paths.
//   * otherwise: the portable scalar decoder below — baseline sequential
//     8-bit, Huffman, grayscale/YCbCr with 1x1/2x1/2x2 subsampling. It
//     replicates libjpeg's integer pipeline *exactly* (islow IDCT, fancy
//     triangular chroma upsampling, the fixed-point YCbCr tables), so the
//     two backends are bit-identical on every file they both accept.
//
// Both backends are strict: any corruption libjpeg would only *warn* about
// (truncated entropy data, bad Huffman codes) is a hard error here, so a
// corrupt record is charged against the loader's max_bad_records budget
// identically whether the decode ran natively or through PIL.
//
// The resize stage replicates Pillow's two-pass fixed-point bilinear
// resampler (triangle filter, PRECISION_BITS=22, the `box=` source-rect
// contract) coefficient-for-coefficient: pixels produced here are
// byte-identical to `Image.resize(size, BILINEAR, box=...)` on the same
// raster, which is what lets the Python layer keep PIL as the bit-exactness
// oracle and runtime fallback. TFR_OMIT_JPEG reproduces a pre-JPEG build of
// this library (no jpg_* exports) for the stale-.so fallback tests.

#ifndef TFR_OMIT_JPEG

#include <cmath>

#ifdef TFR_USE_LIBJPEG
#include <csetjmp>
#include <jpeglib.h>
#endif

namespace jpg {

// decoded images are capped well above ImageNet scale but low enough that a
// fuzzed 65k x 65k header cannot drive a multi-GB allocation
const uint64_t kMaxPixels = 1ull << 24;  // 16.7 Mpx (4096 x 4096)

void set_jerr(const char* msg) {
  snprintf(g_err, sizeof(g_err), "jpeg: %s", msg);
}

#ifdef TFR_USE_LIBJPEG

struct ErrMgr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void err_exit(j_common_ptr cinfo) {
  longjmp(((ErrMgr*)cinfo->err)->jb, 1);
}

// corruption warnings (truncated stream, bad Huffman code) become hard
// errors: PIL raises on the same inputs, and the loader's max_bad_records
// budget must charge the record identically in native and PIL modes
void err_emit(j_common_ptr cinfo, int msg_level) {
  if (msg_level == -1) longjmp(((ErrMgr*)cinfo->err)->jb, 1);
}

// malloc'd W*H*3 RGB raster, or nullptr with g_err set
uint8_t* decode_rgb(const uint8_t* data, size_t len, int* W, int* H) {
  jpeg_decompress_struct c;
  ErrMgr err;
  uint8_t* out = nullptr;
  c.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = err_exit;
  err.mgr.emit_message = err_emit;
  if (setjmp(err.jb)) {
    char buf[JMSG_LENGTH_MAX];
    (*c.err->format_message)((j_common_ptr)&c, buf);
    set_jerr(buf);
    jpeg_destroy_decompress(&c);
    free(out);
    return nullptr;
  }
  jpeg_create_decompress(&c);
  jpeg_mem_src(&c, data, (unsigned long)len);
  jpeg_read_header(&c, TRUE);
  if ((uint64_t)c.image_width * c.image_height > kMaxPixels) {
    set_jerr("image too large");
    jpeg_destroy_decompress(&c);
    return nullptr;
  }
  c.out_color_space = JCS_RGB;
  jpeg_start_decompress(&c);
  *W = (int)c.output_width;
  *H = (int)c.output_height;
  out = (uint8_t*)malloc((size_t)*W * *H * 3);
  if (!out) {
    set_jerr("out of memory for raster");
    jpeg_destroy_decompress(&c);
    return nullptr;
  }
  while (c.output_scanline < c.output_height) {
    JSAMPROW row = out + (size_t)c.output_scanline * *W * 3;
    jpeg_read_scanlines(&c, &row, 1);
  }
  jpeg_finish_decompress(&c);
  jpeg_destroy_decompress(&c);
  return out;
}

#else  // scalar fallback decoder

// libjpeg's post-IDCT range limit table, as a function: index the wrapped
// 10-bit value exactly the way prepare_range_limit_table lays it out, so
// even wild out-of-range IDCT outputs clamp identically
inline uint8_t idct_range(int64_t v) {
  int x = (int)(v & 1023);
  if (x < 128) return (uint8_t)(x + 128);
  if (x < 512) return 255;
  if (x < 896) return 0;
  return (uint8_t)(x - 896);
}

inline uint8_t clamp255(int v) {
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// jpeg_idct_islow's fixed-point constants (CONST_BITS=13)
const int64_t kFix_0_298631336 = 2446, kFix_0_390180644 = 3196,
              kFix_0_541196100 = 4433, kFix_0_765366865 = 6270,
              kFix_0_899976223 = 7373, kFix_1_175875602 = 9633,
              kFix_1_501321110 = 12299, kFix_1_847759065 = 15137,
              kFix_1_961570560 = 16069, kFix_2_053119869 = 16819,
              kFix_2_562915447 = 20995, kFix_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + ((int64_t)1 << (n - 1))) >> n;
}

// libjpeg jidctint.c jpeg_idct_islow, verbatim math: coef (natural order) x
// quant -> 8x8 samples at out/stride. 64-bit accumulators match libjpeg's
// JLONG on LP64 hosts (and sidestep signed overflow on fuzzed garbage).
void idct_islow(const int16_t* coef, const uint16_t* quant, uint8_t* out,
                size_t stride) {
  const int kConstBits = 13, kPass1Bits = 2;
  int64_t ws[64];
  for (int ctr = 0; ctr < 8; ctr++) {  // pass 1: columns
    const int16_t* in = coef + ctr;
    const uint16_t* q = quant + ctr;
    int64_t* w = ws + ctr;
    if (!(in[8] | in[16] | in[24] | in[32] | in[40] | in[48] | in[56])) {
      // multiplications, not <<: left-shifting a negative signed value is UB
      int64_t dc = (int64_t)in[0] * q[0] * ((int64_t)1 << kPass1Bits);
      for (int i = 0; i < 8; i++) w[i * 8] = dc;
      continue;
    }
    int64_t z2 = (int64_t)in[16] * q[16], z3 = (int64_t)in[48] * q[48];
    int64_t z1 = (z2 + z3) * kFix_0_541196100;
    int64_t tmp2 = z1 + z3 * (-kFix_1_847759065);
    int64_t tmp3 = z1 + z2 * kFix_0_765366865;
    z2 = (int64_t)in[0] * q[0];
    z3 = (int64_t)in[32] * q[32];
    int64_t tmp0 = (z2 + z3) * ((int64_t)1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * ((int64_t)1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)in[56] * q[56];
    tmp1 = (int64_t)in[40] * q[40];
    tmp2 = (int64_t)in[24] * q[24];
    tmp3 = (int64_t)in[8] * q[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * kFix_1_175875602;
    tmp0 *= kFix_0_298631336;
    tmp1 *= kFix_2_053119869;
    tmp2 *= kFix_3_072711026;
    tmp3 *= kFix_1_501321110;
    z1 *= -kFix_0_899976223;
    z2 *= -kFix_2_562915447;
    z3 = z3 * (-kFix_1_961570560) + z5;
    z4 = z4 * (-kFix_0_390180644) + z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    w[8 * 0] = descale(tmp10 + tmp3, kConstBits - kPass1Bits);
    w[8 * 7] = descale(tmp10 - tmp3, kConstBits - kPass1Bits);
    w[8 * 1] = descale(tmp11 + tmp2, kConstBits - kPass1Bits);
    w[8 * 6] = descale(tmp11 - tmp2, kConstBits - kPass1Bits);
    w[8 * 2] = descale(tmp12 + tmp1, kConstBits - kPass1Bits);
    w[8 * 5] = descale(tmp12 - tmp1, kConstBits - kPass1Bits);
    w[8 * 3] = descale(tmp13 + tmp0, kConstBits - kPass1Bits);
    w[8 * 4] = descale(tmp13 - tmp0, kConstBits - kPass1Bits);
  }
  for (int ctr = 0; ctr < 8; ctr++) {  // pass 2: rows
    const int64_t* w = ws + ctr * 8;
    uint8_t* o = out + ctr * stride;
    if (!(w[1] | w[2] | w[3] | w[4] | w[5] | w[6] | w[7])) {
      uint8_t dc = idct_range(descale(w[0], kPass1Bits + 3));
      for (int i = 0; i < 8; i++) o[i] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * kFix_0_541196100;
    int64_t tmp2 = z1 + z3 * (-kFix_1_847759065);
    int64_t tmp3 = z1 + z2 * kFix_0_765366865;
    int64_t tmp0 = (w[0] + w[4]) * ((int64_t)1 << kConstBits);
    int64_t tmp1 = (w[0] - w[4]) * ((int64_t)1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * kFix_1_175875602;
    tmp0 *= kFix_0_298631336;
    tmp1 *= kFix_2_053119869;
    tmp2 *= kFix_3_072711026;
    tmp3 *= kFix_1_501321110;
    z1 *= -kFix_0_899976223;
    z2 *= -kFix_2_562915447;
    z3 = z3 * (-kFix_1_961570560) + z5;
    z4 = z4 * (-kFix_0_390180644) + z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int kShift = kConstBits + kPass1Bits + 3;
    o[0] = idct_range(descale(tmp10 + tmp3, kShift));
    o[7] = idct_range(descale(tmp10 - tmp3, kShift));
    o[1] = idct_range(descale(tmp11 + tmp2, kShift));
    o[6] = idct_range(descale(tmp11 - tmp2, kShift));
    o[2] = idct_range(descale(tmp12 + tmp1, kShift));
    o[5] = idct_range(descale(tmp12 - tmp1, kShift));
    o[3] = idct_range(descale(tmp13 + tmp0, kShift));
    o[4] = idct_range(descale(tmp13 - tmp0, kShift));
  }
}

struct Huff {
  bool present = false;
  uint8_t vals[256];
  int32_t mincode[17], maxcode[18], valptr[17];
  uint8_t look_nbits[256], look_val[256];

  bool build(const uint8_t* counts, const uint8_t* symbols, int nsym) {
    present = true;
    memcpy(vals, symbols, nsym);
    // canonical code assignment (JPEG spec DECODE tables)
    int code = 0, k = 0;
    for (int l = 1; l <= 16; l++) {
      valptr[l] = k;
      mincode[l] = code;
      code += counts[l - 1];
      k += counts[l - 1];
      maxcode[l] = code - 1;
      if (counts[l - 1] == 0) maxcode[l] = -1;
      if (code - 1 >= (1 << l)) return false;  // oversubscribed table
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;  // sentinel: length-17 lookups always fail
    // 8-bit lookahead table (libjpeg's jpeg_make_d_derived_tbl fast path)
    memset(look_nbits, 0, sizeof(look_nbits));
    int p = 0;
    code = 0;
    for (int l = 1; l <= 8; l++) {
      code = mincode[l];
      for (int i = 0; i < counts[l - 1]; i++, code++, p++) {
        int lookbits = code << (8 - l);
        for (int ctr = 1 << (8 - l); ctr > 0; ctr--, lookbits++) {
          look_nbits[lookbits] = (uint8_t)l;
          look_val[lookbits] = vals[p];
        }
      }
    }
    return true;
  }
};

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int dw = 0, dh = 0;  // downsampled sample dims (pre-upsample)
  int pw = 0, ph = 0;  // padded plane dims (whole MCUs)
  uint8_t* plane = nullptr;
  int pred = 0;  // DC predictor
};

struct Decoder {
  const uint8_t* d;
  size_t n, pos = 0;
  uint16_t qt[4][64];  // natural order
  bool qt_ok[4] = {false, false, false, false};
  Huff hdc[4], hac[4];
  int W = 0, H = 0, ncomp = 0, hmax = 1, vmax = 1, restart_interval = 0;
  Comp comp[3];
  uint32_t bitbuf = 0;
  int bitcnt = 0;
  bool hit_marker = false;  // entropy reader ran into an unexpected marker

  Decoder(const uint8_t* data, size_t len) : d(data), n(len) {}
  ~Decoder() {
    for (int i = 0; i < 3; i++) free(comp[i].plane);
  }

  bool fail(const char* msg) {
    set_jerr(msg);
    return false;
  }

  bool need(size_t k) { return pos + k <= n; }

  int u8() { return d[pos++]; }
  int u16() {
    int v = (d[pos] << 8) | d[pos + 1];
    pos += 2;
    return v;
  }

  // -- entropy-coded bit reader (0xFF00 unstuffing, markers stop the feed) --

  bool fill_bits() {
    while (bitcnt <= 24) {
      if (pos >= n) return false;
      int b = d[pos];
      if (b == 0xff) {
        if (pos + 1 >= n) return false;
        if (d[pos + 1] != 0x00) {
          hit_marker = true;  // restart or premature end-of-scan
          return false;
        }
        pos += 2;
      } else {
        pos += 1;
      }
      bitbuf = (bitbuf << 8) | (uint32_t)b;
      bitcnt += 8;
    }
    return true;
  }

  int get_bits(int s) {  // -1 on truncation
    if (s == 0) return 0;
    if (bitcnt < s && !fill_bits() && bitcnt < s) return -1;
    int v = (int)((bitbuf >> (bitcnt - s)) & ((1u << s) - 1));
    bitcnt -= s;
    return v;
  }

  static int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }

  int huff_decode(const Huff& h) {  // -1 on error
    if (bitcnt < 16) fill_bits();
    if (bitcnt >= 8) {
      int look = (int)((bitbuf >> (bitcnt - 8)) & 0xff);
      int nb = h.look_nbits[look];
      if (nb) {
        bitcnt -= nb;
        return h.look_val[look];
      }
    }
    int code = 0, l = 0;
    while (l < 17) {
      l++;
      int bit = get_bits(1);
      if (bit < 0) return -1;
      code = (code << 1) | bit;
      if (l <= 16 && h.maxcode[l] >= 0 && code <= h.maxcode[l])
        return h.vals[h.valptr[l] + code - h.mincode[l]];
    }
    return -1;  // code longer than any table entry: corrupt stream
  }

  bool decode_block(Comp& c, int16_t* coef) {
    memset(coef, 0, 64 * sizeof(int16_t));
    if (!hdc[c.td].present || !hac[c.ta].present) return fail("missing Huffman table");
    int t = huff_decode(hdc[c.td]);
    if (t < 0 || t > 15) return fail("bad DC code");
    if (t) {
      int v = get_bits(t);
      if (v < 0) return fail("truncated entropy data");
      c.pred += extend(v, t);
    }
    coef[0] = (int16_t)c.pred;
    for (int k = 1; k < 64;) {
      int rs = huff_decode(hac[c.ta]);
      if (rs < 0) return fail("bad AC code");
      int r = rs >> 4, s = rs & 15;
      if (s == 0) {
        if (r != 15) break;  // EOB
        k += 16;             // ZRL
        continue;
      }
      k += r;
      if (k > 63) return fail("AC run past block end");
      int v = get_bits(s);
      if (v < 0) return fail("truncated entropy data");
      coef[kZigzag[k]] = (int16_t)extend(v, s);
      k++;
    }
    return true;
  }

  // -- marker parsing -------------------------------------------------------

  bool parse_dqt() {
    if (!need(2)) return fail("truncated DQT");
    int len = u16() - 2;
    while (len > 0) {
      if (!need(1)) return fail("truncated DQT");
      int pq_tq = u8();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      len -= 1;
      if (pq > 1 || tq > 3) return fail("bad DQT header");
      int nbytes = pq ? 128 : 64;
      if (!need(nbytes) || len < nbytes) return fail("truncated DQT");
      for (int i = 0; i < 64; i++) {
        int v = pq ? u16() : u8();
        if (v == 0) return fail("zero quantizer");
        qt[tq][kZigzag[i]] = (uint16_t)v;
      }
      qt_ok[tq] = true;
      len -= nbytes;
    }
    return true;
  }

  bool parse_dht() {
    if (!need(2)) return fail("truncated DHT");
    int len = u16() - 2;
    while (len > 0) {
      if (len < 17 || !need(17)) return fail("truncated DHT");
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) return fail("bad DHT header");
      uint8_t counts[16];
      int nsym = 0;
      for (int i = 0; i < 16; i++) {
        counts[i] = (uint8_t)u8();
        nsym += counts[i];
      }
      len -= 17;
      if (nsym > 256 || len < nsym || !need(nsym)) return fail("truncated DHT");
      Huff& h = tc ? hac[th] : hdc[th];
      if (!h.build(counts, d + pos, nsym)) return fail("oversubscribed Huffman table");
      pos += nsym;
      len -= nsym;
    }
    return true;
  }

  bool parse_sof(int marker) {
    if (marker == 0xc2) return fail("progressive JPEG unsupported by scalar decoder");
    if (marker != 0xc0 && marker != 0xc1)
      return fail("unsupported SOF type");
    if (!need(8)) return fail("truncated SOF");
    int len = u16();
    int prec = u8();
    H = u16();
    W = u16();
    ncomp = u8();
    if (prec != 8) return fail("only 8-bit precision supported");
    if (W < 1 || H < 1) return fail("bad dimensions");
    if ((uint64_t)W * H > kMaxPixels) return fail("image too large");
    if (ncomp != 1 && ncomp != 3) return fail("unsupported component count");
    if (len != 8 + 3 * ncomp || !need(3 * (size_t)ncomp)) return fail("bad SOF length");
    for (int i = 0; i < ncomp; i++) {
      comp[i].id = u8();
      int hv = u8();
      comp[i].h = hv >> 4;
      comp[i].v = hv & 15;
      comp[i].tq = u8();
      if (comp[i].h < 1 || comp[i].v < 1 || comp[i].tq > 3)
        return fail("bad component spec");
      if (comp[i].h > hmax) hmax = comp[i].h;
      if (comp[i].v > vmax) vmax = comp[i].v;
    }
    if (ncomp == 1) {
      // single-component scans ignore sampling factors (spec B.2.3; libjpeg
      // normalizes them too) — PIL writes 2x2 here when subsampling is forced
      comp[0].h = comp[0].v = hmax = vmax = 1;
    } else {
      // luma h2v2 / h2v1 / h1v1 with 1x1 chroma: the layouts PIL and every
      // mainstream encoder emit; anything else falls back to PIL
      if (comp[1].h != 1 || comp[1].v != 1 || comp[2].h != 1 || comp[2].v != 1 ||
          comp[0].h > 2 || comp[0].v > 2 || comp[0].v > comp[0].h)
        return fail("unsupported chroma sampling");
    }
    int mcux = (W + hmax * 8 - 1) / (hmax * 8);
    int mcuy = (H + vmax * 8 - 1) / (vmax * 8);
    for (int i = 0; i < ncomp; i++) {
      Comp& c = comp[i];
      c.dw = (W * c.h + hmax - 1) / hmax;
      c.dh = (H * c.v + vmax - 1) / vmax;
      c.pw = mcux * c.h * 8;
      c.ph = mcuy * c.v * 8;
      c.plane = (uint8_t*)malloc((size_t)c.pw * c.ph);
      if (!c.plane) return fail("out of memory for plane");
    }
    return true;
  }

  bool skip_segment() {
    if (!need(2)) return fail("truncated segment");
    int len = u16();
    if (len < 2 || !need((size_t)len - 2)) return fail("truncated segment");
    pos += len - 2;
    return true;
  }

  bool parse_sos_header() {
    if (!need(3)) return fail("truncated SOS");
    u16();  // length
    int ns = u8();
    if (ns != ncomp) return fail("non-interleaved scan unsupported");
    if (!need(2 * (size_t)ns + 3)) return fail("truncated SOS");
    for (int i = 0; i < ns; i++) {
      int cs = u8(), tdta = u8();
      Comp* c = nullptr;
      for (int j = 0; j < ncomp; j++)
        if (comp[j].id == cs) c = &comp[j];
      if (!c) return fail("SOS references unknown component");
      c->td = tdta >> 4;
      c->ta = tdta & 15;
      if (c->td > 3 || c->ta > 3) return fail("bad SOS table selector");
    }
    int ss = u8(), se = u8(), ahal = u8();
    if (ss != 0 || se != 63 || ahal != 0) return fail("non-baseline scan parameters");
    return true;
  }

  bool decode_scan() {
    for (int i = 0; i < ncomp; i++) {
      if (!qt_ok[comp[i].tq]) return fail("missing quant table");
      comp[i].pred = 0;
    }
    int mcux = comp[0].pw / (comp[0].h * 8);
    int mcuy = comp[0].ph / (comp[0].v * 8);
    int16_t coef[64];
    int mcus_to_restart = restart_interval;
    int next_rst = 0;
    for (int my = 0; my < mcuy; my++) {
      for (int mx = 0; mx < mcux; mx++) {
        if (restart_interval && mcus_to_restart == 0) {
          // byte-align, then consume the RSTn marker the feeder stopped at
          bitcnt = 0;
          bitbuf = 0;
          hit_marker = false;
          if (!need(2) || d[pos] != 0xff || d[pos + 1] != (0xd0 | next_rst))
            return fail("missing restart marker");
          pos += 2;
          next_rst = (next_rst + 1) & 7;
          mcus_to_restart = restart_interval;
          for (int i = 0; i < ncomp; i++) comp[i].pred = 0;
        }
        for (int i = 0; i < ncomp; i++) {
          Comp& c = comp[i];
          for (int by = 0; by < c.v; by++) {
            for (int bx = 0; bx < c.h; bx++) {
              if (!decode_block(c, coef)) return false;
              size_t ox = ((size_t)mx * c.h + bx) * 8;
              size_t oy = ((size_t)my * c.v + by) * 8;
              idct_islow(coef, qt[c.tq], c.plane + oy * c.pw + ox, c.pw);
            }
          }
        }
        if (restart_interval) mcus_to_restart--;
      }
    }
    return true;
  }

  bool parse() {
    if (n < 2 || d[0] != 0xff || d[1] != 0xd8) return fail("not a JPEG (no SOI)");
    pos = 2;
    bool have_sof = false;
    while (true) {
      // scan to the next marker, skipping fill bytes
      if (!need(2)) return fail("truncated stream");
      if (d[pos] != 0xff) return fail("garbage between segments");
      while (need(1) && d[pos] == 0xff) pos++;
      if (!need(1)) return fail("truncated stream");
      int marker = u8();
      if (marker == 0xd9) return fail("EOI before image data");
      if (marker == 0xda) {  // SOS
        if (!have_sof) return fail("SOS before SOF");
        if (!parse_sos_header()) return false;
        bitbuf = 0;
        bitcnt = 0;
        hit_marker = false;
        if (!decode_scan()) return false;
        // the stream must close cleanly: byte-align and require EOI (after
        // optional fill bytes) — matching the strict-warning libjpeg path
        bitcnt = 0;
        if (!need(2)) return fail("truncated after scan");
        if (d[pos] != 0xff) return fail("garbage after scan");
        while (need(1) && d[pos] == 0xff) pos++;
        if (!need(1) || u8() != 0xd9) return fail("missing EOI");
        return true;
      }
      switch (marker) {
        case 0xc4:
          if (!parse_dht()) return false;
          break;
        case 0xdb:
          if (!parse_dqt()) return false;
          break;
        case 0xdd:
          if (!need(4)) return fail("truncated DRI");
          u16();
          restart_interval = u16();
          break;
        case 0xc0:
        case 0xc1:
        case 0xc2:
        case 0xc3:
        case 0xc5:
        case 0xc6:
        case 0xc7:
        case 0xc9:
        case 0xca:
        case 0xcb:
        case 0xcd:
        case 0xce:
        case 0xcf:
          if (have_sof) return fail("multiple SOF markers");
          if (!parse_sof(marker)) return false;
          have_sof = true;
          break;
        default:
          if (marker == 0x01 || (marker >= 0xd0 && marker <= 0xd7))
            break;  // standalone markers: no length field
          if (!skip_segment()) return false;
      }
    }
  }
};

// libjpeg jdsample.c h2v1_fancy_upsample, one row: dw input samples (from a
// padded plane row, so the dw<=2 pointer walk reads decoded bytes exactly
// like libjpeg's padded sample buffers) to 2*dw output samples
void h2v1_fancy_row(const uint8_t* in, int dw, uint8_t* out) {
  const uint8_t* inptr = in;
  uint8_t* outptr = out;
  int invalue = *inptr++;
  *outptr++ = (uint8_t)invalue;
  *outptr++ = (uint8_t)((invalue * 3 + *inptr + 2) >> 2);
  for (int colctr = dw - 2; colctr > 0; colctr--) {
    invalue = *inptr++ * 3;
    *outptr++ = (uint8_t)((invalue + inptr[-2] + 1) >> 2);
    *outptr++ = (uint8_t)((invalue + *inptr + 2) >> 2);
  }
  invalue = *inptr;
  *outptr++ = (uint8_t)((invalue * 3 + inptr[-1] + 1) >> 2);
  *outptr++ = (uint8_t)invalue;
}

// libjpeg jdsample.c h2v2_fancy_upsample, one output row: the vertical
// triangle (3*nearer + farther) then the horizontal one, biases 8/7
void h2v2_fancy_row(const uint8_t* near_row, const uint8_t* far_row, int dw,
                    uint8_t* out) {
  const uint8_t *inptr0 = near_row, *inptr1 = far_row;
  uint8_t* outptr = out;
  int thiscolsum = (*inptr0++) * 3 + (*inptr1++);
  int nextcolsum = (*inptr0++) * 3 + (*inptr1++);
  *outptr++ = (uint8_t)((thiscolsum * 4 + 8) >> 4);
  *outptr++ = (uint8_t)((thiscolsum * 3 + nextcolsum + 7) >> 4);
  int lastcolsum = thiscolsum;
  thiscolsum = nextcolsum;
  for (int colctr = dw - 2; colctr > 0; colctr--) {
    nextcolsum = (*inptr0++) * 3 + (*inptr1++);
    *outptr++ = (uint8_t)((thiscolsum * 3 + lastcolsum + 8) >> 4);
    *outptr++ = (uint8_t)((thiscolsum * 3 + nextcolsum + 7) >> 4);
    lastcolsum = thiscolsum;
    thiscolsum = nextcolsum;
  }
  *outptr++ = (uint8_t)((thiscolsum * 3 + lastcolsum + 8) >> 4);
  *outptr++ = (uint8_t)((thiscolsum * 4 + 7) >> 4);
}

// libjpeg jdcolor.c build_ycc_rgb_table + ycc_rgb_convert, SCALEBITS=16
struct YccTables {
  int crr[256], cbb[256], crg[256], cbg[256];
  YccTables() {
    const int64_t kScale = 1 << 16, kHalf = 1 << 15;
    for (int i = 0; i < 256; i++) {
      int x = i - 128;
      crr[i] = (int)(((int64_t)(1.40200 * kScale + 0.5) * x + kHalf) >> 16);
      cbb[i] = (int)(((int64_t)(1.77200 * kScale + 0.5) * x + kHalf) >> 16);
      crg[i] = (int)(-(int64_t)(0.71414 * kScale + 0.5) * x);
      cbg[i] = (int)(-(int64_t)(0.34414 * kScale + 0.5) * x + kHalf);
    }
  }
};

uint8_t* decode_rgb(const uint8_t* data, size_t len, int* W, int* H) {
  Decoder dec(data, len);
  if (!dec.parse()) return nullptr;
  *W = dec.W;
  *H = dec.H;
  size_t w = dec.W, h = dec.H;
  uint8_t* rgb = (uint8_t*)malloc(w * h * 3);
  if (!rgb) {
    set_jerr("out of memory for raster");
    return nullptr;
  }
  if (dec.ncomp == 1) {  // gray_rgb_convert: replicate Y
    const Comp& y = dec.comp[0];
    for (size_t r = 0; r < h; r++) {
      const uint8_t* yr = y.plane + r * y.pw;
      uint8_t* o = rgb + r * w * 3;
      for (size_t c = 0; c < w; c++) {
        o[c * 3] = o[c * 3 + 1] = o[c * 3 + 2] = yr[c];
      }
    }
    return rgb;
  }
  static const YccTables kYcc;
  const Comp& y = dec.comp[0];
  const Comp& cb = dec.comp[1];
  const Comp& cr = dec.comp[2];
  int hexp = y.h, vexp = y.v;  // chroma expansion factors (1 or 2)
  // upsampled chroma row buffers; +2 columns absorb the 4-sample write the
  // first/last special cases emit when dw <= 2 (libjpeg writes into padded
  // row buffers the same way)
  uint8_t* cbrow = (uint8_t*)malloc((size_t)cb.dw * 2 + 2);
  uint8_t* crrow = (uint8_t*)malloc((size_t)cr.dw * 2 + 2);
  if (!cbrow || !crrow) {
    free(cbrow);
    free(crrow);
    free(rgb);
    set_jerr("out of memory for chroma rows");
    return nullptr;
  }
  // libjpeg-turbo only selects the fancy (triangle) upsamplers when
  // downsampled_width > 2; tiny widths take the plain replication
  // upsampler instead (jdsample.c start_pass) — mirror that exactly
  bool fancy = cb.dw > 2;
  for (size_t r = 0; r < h; r++) {
    const uint8_t *cbr, *crr;
    if (hexp == 2 && !fancy) {  // h2v2_upsample / h2v1_upsample: replicate
      size_t inrow = (vexp == 2) ? (r >> 1) : r;
      const uint8_t* cbp = cb.plane + inrow * cb.pw;
      const uint8_t* crp = cr.plane + inrow * cr.pw;
      for (int x = 0; x < cb.dw; x++) {
        cbrow[x * 2] = cbrow[x * 2 + 1] = cbp[x];
        crrow[x * 2] = crrow[x * 2 + 1] = crp[x];
      }
      cbr = cbrow;
      crr = crrow;
    } else if (hexp == 2 && vexp == 2) {
      size_t inrow = r >> 1;
      // context row with edge duplication (jdmainct's duplicated rows)
      size_t other = (r & 1) ? (inrow + 1 < (size_t)cb.dh ? inrow + 1 : inrow)
                             : (inrow > 0 ? inrow - 1 : inrow);
      h2v2_fancy_row(cb.plane + inrow * cb.pw, cb.plane + other * cb.pw, cb.dw, cbrow);
      h2v2_fancy_row(cr.plane + inrow * cr.pw, cr.plane + other * cr.pw, cr.dw, crrow);
      cbr = cbrow;
      crr = crrow;
    } else if (hexp == 2) {  // h2v1
      h2v1_fancy_row(cb.plane + r * cb.pw, cb.dw, cbrow);
      h2v1_fancy_row(cr.plane + r * cr.pw, cr.dw, crrow);
      cbr = cbrow;
      crr = crrow;
    } else {  // h1v1: direct
      cbr = cb.plane + r * cb.pw;
      crr = cr.plane + r * cr.pw;
    }
    const uint8_t* yr = y.plane + r * y.pw;
    uint8_t* o = rgb + r * w * 3;
    for (size_t c = 0; c < w; c++) {
      int yy = yr[c], vcb = cbr[c], vcr = crr[c];
      o[c * 3 + 0] = clamp255(yy + kYcc.crr[vcr]);
      o[c * 3 + 1] = clamp255(yy + ((kYcc.cbg[vcb] + kYcc.crg[vcr]) >> 16));
      o[c * 3 + 2] = clamp255(yy + kYcc.cbb[vcb]);
    }
  }
  free(cbrow);
  free(crrow);
  return rgb;
}

#endif  // TFR_USE_LIBJPEG

// ---------------------------------------------------------------------------
// Pillow-exact bilinear resample (Resample.c, the 8bpc fixed-point path):
// precompute_coeffs + normalize_coeffs_8bpc reproduced bit-for-bit, with the
// `box=` source-rect contract and an output *window* so an eval-style
// "resize then center crop" evaluates only the cropped rows/columns (each
// output pixel depends only on its own coefficients, so the window is
// byte-identical to resize-then-crop).
// ---------------------------------------------------------------------------

const int kPrecisionBits = 32 - 8 - 2;

inline uint8_t resample_clip8(int v) {
  if (v >= (1 << kPrecisionBits << 8)) return 255;
  if (v <= 0) return 0;
  return (uint8_t)(v >> kPrecisionBits);
}

double bilinear_filter(double x) {
  if (x < 0.0) x = -x;
  if (x < 1.0) return 1.0 - x;
  return 0.0;
}

// Pillow precompute_coeffs for the bilinear filter (support 1.0), already
// normalized to the fixed-point integers of normalize_coeffs_8bpc. Returns
// ksize (coeffs per output pixel), or 0 on allocation failure.
int precompute_coeffs(int in_size, double in0, double in1, int out_size,
                      int* bounds, int** kk_out) {
  double filterscale, scale;
  filterscale = scale = (in1 - in0) / out_size;
  if (filterscale < 1.0) filterscale = 1.0;
  double support = 1.0 * filterscale;
  int ksize = (int)ceil(support) * 2 + 1;
  double* prekk = (double*)malloc(sizeof(double) * out_size * ksize);
  int* kk = (int*)malloc(sizeof(int) * out_size * ksize);
  if (!prekk || !kk) {
    free(prekk);
    free(kk);
    return 0;
  }
  for (int xx = 0; xx < out_size; xx++) {
    double center = in0 + (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = prekk + (size_t)xx * ksize;
    int x;
    for (x = 0; x < xmax; x++) {
      double w = bilinear_filter((x + xmin - center + 0.5) * ss) * ss;
      k[x] = w;
      ww += w;
    }
    for (x = 0; x < xmax; x++) {
      if (ww != 0.0) k[x] /= ww;
    }
    for (; x < ksize; x++) k[x] = 0;
    bounds[xx * 2 + 0] = xmin;
    bounds[xx * 2 + 1] = xmax;
  }
  for (int i = 0; i < out_size * ksize; i++) {
    if (prekk[i] < 0) {
      kk[i] = (int)(-0.5 + prekk[i] * (1 << kPrecisionBits));
    } else {
      kk[i] = (int)(0.5 + prekk[i] * (1 << kPrecisionBits));
    }
  }
  free(prekk);
  *kk_out = kk;
  return ksize;
}

// in: [in_h, in_w, 3] RGB. Resize box (bx0..by1) to (rw, rh), emit the
// (ox, oy, ow, oh) window of that resize — optionally mirrored — into out
// (out_stride bytes between rows). Returns 0, or -1 with g_err set.
int resample_window(const uint8_t* in, int in_w, int in_h, double bx0,
                    double by0, double bx1, double by1, int rw, int rh,
                    int ox, int oy, int ow, int oh, int flip, uint8_t* out,
                    int64_t out_stride) {
  int* hb_full = (int*)malloc(sizeof(int) * 2 * rw);
  int* vb_full = (int*)malloc(sizeof(int) * 2 * rh);
  int *kkh_full = nullptr, *kkv_full = nullptr;
  uint8_t* tmp = nullptr;
  int rc = -1;
  if (!hb_full || !vb_full) {
    set_jerr("out of memory for resample bounds");
    goto done;
  }
  {
    int hks = precompute_coeffs(in_w, bx0, bx1, rw, hb_full, &kkh_full);
    int vks = precompute_coeffs(in_h, by0, by1, rh, vb_full, &kkv_full);
    if (!hks || !vks) {
      set_jerr("out of memory for resample coeffs");
      goto done;
    }
    const int* hb = hb_full + 2 * (size_t)ox;
    const int* kkh = kkh_full + (size_t)hks * ox;
    const int* vb = vb_full + 2 * (size_t)oy;
    const int* kkv = kkv_full + (size_t)vks * oy;
    // source rows the window's vertical pass touches
    int ybox_first = vb[0], ybox_last = 0;
    for (int y = 0; y < oh; y++) {
      if (vb[y * 2] < ybox_first) ybox_first = vb[y * 2];
      if (vb[y * 2] + vb[y * 2 + 1] > ybox_last) ybox_last = vb[y * 2] + vb[y * 2 + 1];
    }
    int tmp_h = ybox_last - ybox_first;
    tmp = (uint8_t*)malloc((size_t)tmp_h * ow * 3);
    if (!tmp) {
      set_jerr("out of memory for resample temp");
      goto done;
    }
    for (int yy = 0; yy < tmp_h; yy++) {  // horizontal pass
      const uint8_t* row = in + (size_t)(yy + ybox_first) * in_w * 3;
      uint8_t* trow = tmp + (size_t)yy * ow * 3;
      for (int xx = 0; xx < ow; xx++) {
        int xmin = hb[xx * 2], xmax = hb[xx * 2 + 1];
        const int* k = kkh + (size_t)xx * hks;
        int s0 = 1 << (kPrecisionBits - 1), s1 = s0, s2 = s0;
        for (int x = 0; x < xmax; x++) {
          const uint8_t* p = row + (size_t)(x + xmin) * 3;
          s0 += p[0] * k[x];
          s1 += p[1] * k[x];
          s2 += p[2] * k[x];
        }
        trow[xx * 3 + 0] = resample_clip8(s0);
        trow[xx * 3 + 1] = resample_clip8(s1);
        trow[xx * 3 + 2] = resample_clip8(s2);
      }
    }
    for (int yy = 0; yy < oh; yy++) {  // vertical pass (+ optional mirror)
      int ymin = vb[yy * 2] - ybox_first, ymax = vb[yy * 2 + 1];
      const int* k = kkv + (size_t)yy * vks;
      uint8_t* orow = out + (size_t)yy * out_stride;
      for (int xx = 0; xx < ow; xx++) {
        int s0 = 1 << (kPrecisionBits - 1), s1 = s0, s2 = s0;
        for (int y = 0; y < ymax; y++) {
          const uint8_t* p = tmp + ((size_t)(y + ymin) * ow + xx) * 3;
          s0 += p[0] * k[y];
          s1 += p[1] * k[y];
          s2 += p[2] * k[y];
        }
        int dx = flip ? (ow - 1 - xx) : xx;
        orow[(size_t)dx * 3 + 0] = resample_clip8(s0);
        orow[(size_t)dx * 3 + 1] = resample_clip8(s1);
        orow[(size_t)dx * 3 + 2] = resample_clip8(s2);
      }
    }
    rc = 0;
  }
done:
  free(tmp);
  free(hb_full);
  free(vb_full);
  free(kkh_full);
  free(kkv_full);
  return rc;
}

}  // namespace jpg

#define TFR_STRINGIZE_(x) #x
#define TFR_STRINGIZE(x) TFR_STRINGIZE_(x)

extern "C" {

// Compile-time build fingerprint: which decode backend this .so carries.
// Asserted by tests so a stale scalar build on a libjpeg host is visible.
const char* tfr_build_info() {
#ifdef TFR_USE_LIBJPEG
  return "tfrecord_io jpeg=libjpeg-turbo api=" TFR_STRINGIZE(JPEG_LIB_VERSION);
#else
  return "tfrecord_io jpeg=scalar";
#endif
}

// Header-only probe: image dimensions without a full decode. Returns 0, or
// -1 with tfr_last_error set.
int32_t jpg_info(const uint8_t* data, int64_t len, int32_t* w, int32_t* h) {
  g_err[0] = 0;
#ifdef TFR_USE_LIBJPEG
  jpeg_decompress_struct c;
  jpg::ErrMgr err;
  c.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpg::err_exit;
  err.mgr.emit_message = jpg::err_emit;
  if (setjmp(err.jb)) {
    char buf[JMSG_LENGTH_MAX];
    (*c.err->format_message)((j_common_ptr)&c, buf);
    jpg::set_jerr(buf);
    jpeg_destroy_decompress(&c);
    return -1;
  }
  jpeg_create_decompress(&c);
  jpeg_mem_src(&c, data, (unsigned long)len);
  jpeg_read_header(&c, TRUE);
  *w = (int32_t)c.image_width;
  *h = (int32_t)c.image_height;
  jpeg_destroy_decompress(&c);
  return 0;
#else
  // walk markers through the whole header, the way jpeg_read_header does:
  // dims come from SOF, but success requires reaching SOS with every segment
  // intact — a stream truncated inside its tables errors in BOTH variants
  if (len < 2 || data[0] != 0xff || data[1] != 0xd8) {
    jpg::set_jerr("not a JPEG (no SOI)");
    return -1;
  }
  size_t pos = 2;
  bool have_dims = false;
  while (true) {
    if (pos >= (size_t)len) {
      jpg::set_jerr("truncated stream");
      return -1;
    }
    if (data[pos] != 0xff) {
      jpg::set_jerr("garbage between segments");
      return -1;
    }
    while (pos < (size_t)len && data[pos] == 0xff) pos++;
    if (pos >= (size_t)len) {
      jpg::set_jerr("truncated stream");
      return -1;
    }
    int marker = data[pos++];
    if (marker == 0xd9) {
      jpg::set_jerr("EOI before image data");
      return -1;
    }
    if (marker == 0xda) {
      if (!have_dims) {
        jpg::set_jerr("SOS before SOF");
        return -1;
      }
      return 0;
    }
    if (marker == 0x01 || (marker >= 0xd0 && marker <= 0xd7)) continue;
    if (pos + 2 > (size_t)len) {
      jpg::set_jerr("truncated segment");
      return -1;
    }
    int seglen = (data[pos] << 8) | data[pos + 1];
    if (seglen < 2 || pos + (size_t)seglen > (size_t)len) {
      jpg::set_jerr("truncated segment");
      return -1;
    }
    if ((marker >= 0xc0 && marker <= 0xcf) && marker != 0xc4 && marker != 0xc8 &&
        marker != 0xcc) {
      if (seglen < 8) {
        jpg::set_jerr("bad SOF length");
        return -1;
      }
      *h = (int32_t)((data[pos + 3] << 8) | data[pos + 4]);
      *w = (int32_t)((data[pos + 5] << 8) | data[pos + 6]);
      if (*w < 1 || *h < 1) {
        jpg::set_jerr("bad dimensions");
        return -1;
      }
      have_dims = true;
    }
    pos += (size_t)seglen;
  }
#endif
}

// Decode `data`, resize the source rect (bx0,by0)-(bx1,by1) to (rw, rh)
// with Pillow's bilinear resampler, and write the (ox, oy, ow, oh) window
// of that resize — h-mirrored when flip — into `out` (uint8 RGB rows,
// `out_stride` bytes apart: a shared-memory slab slot). Returns 0, or -1
// with tfr_last_error set (corrupt stream, unsupported coding, bad params).
int32_t jpg_decode_window(const uint8_t* data, int64_t len, double bx0,
                          double by0, double bx1, double by1, int32_t rw,
                          int32_t rh, int32_t ox, int32_t oy, int32_t ow,
                          int32_t oh, int32_t flip, uint8_t* out,
                          int64_t out_stride) {
  g_err[0] = 0;
  int W = 0, H = 0;
  if (rw < 1 || rh < 1 || ow < 1 || oh < 1 || ox < 0 || oy < 0 ||
      ox + ow > rw || oy + oh > rh) {
    jpg::set_jerr("bad resize/window geometry");
    return -1;
  }
  uint8_t* rgb = jpg::decode_rgb(data, (size_t)len, &W, &H);
  if (!rgb) return -1;
  int rc = -1;
  if (!(bx0 >= 0 && by0 >= 0 && bx1 <= W && by1 <= H && bx0 < bx1 && by0 < by1)) {
    jpg::set_jerr("resize box outside the decoded image");
  } else {
    rc = jpg::resample_window(rgb, W, H, bx0, by0, bx1, by1, rw, rh, ox, oy,
                              ow, oh, flip, out, out_stride);
  }
  free(rgb);
  return rc;
}

}  // extern "C"

#endif  // TFR_OMIT_JPEG
