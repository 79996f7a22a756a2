// HEIF/AVIF decode for the thumbnailer and the metadata extractor.
//
// The port's copy of spacedrive_tpu/native/sd_heif.cc (the sd-images `heif`
// feature, crates/images/src/lib.rs:27-28). libheif is bound through
// dlopen/dlsym against its stable public C API (the declarations below are
// written from the documented libheif 1.x API, not copied headers), so the
// build needs no libheif headers and links only -ldl. Where the runtime
// (libheif.so.1) is missing, sd_heif_available() reports 0 and every call
// returns -1; the encode helper (a test fixture writer) reports -4 where
// the libheif build has no HEVC or AV1 encoder.

#include <dlfcn.h>

#include <cstdint>
#include <cstring>

namespace {

// -- minimal API surface (libheif public C API, 1.x) ------------------------

struct heif_error_t {
  int code;      // 0 == Ok
  int subcode;
  const char* message;
};

constexpr int kColorspaceRGB = 1;       // heif_colorspace_RGB
constexpr int kChromaInterleavedRGB = 10;  // heif_chroma_interleaved_RGB
constexpr int kChannelInterleaved = 10;    // heif_channel_interleaved
constexpr int kCompressionHEVC = 1;        // heif_compression_HEVC
constexpr int kCompressionAV1 = 4;         // heif_compression_AV1

using ctx_alloc_t = void* (*)();
using ctx_free_t = void (*)(void*);
using ctx_read_file_t = heif_error_t (*)(void*, const char*, const void*);
using ctx_primary_handle_t = heif_error_t (*)(void*, void**);
using handle_release_t = void (*)(void*);
using handle_dim_t = int (*)(void*);
using decode_image_t = heif_error_t (*)(void*, void**, int, int, const void*);
using image_release_t = void (*)(void*);
using image_plane_ro_t = const uint8_t* (*)(void*, int, int*);
using image_get_dim_t = int (*)(const void*, int);
using ctx_get_encoder_t = heif_error_t (*)(void*, int, void**);
using encoder_release_t = void (*)(void*);
using encoder_lossy_q_t = heif_error_t (*)(void*, int);
using image_create_t = heif_error_t (*)(int, int, int, int, void**);
using image_add_plane_t = heif_error_t (*)(void*, int, int, int, int);
using image_plane_t = uint8_t* (*)(void*, int, int*);
using ctx_encode_t = heif_error_t (*)(void*, void*, void*, const void*, void**);
using ctx_write_file_t = heif_error_t (*)(void*, const char*);

struct Heif {
  void* dl = nullptr;
  ctx_alloc_t ctx_alloc;
  ctx_free_t ctx_free;
  ctx_read_file_t ctx_read_file;
  ctx_primary_handle_t ctx_primary_handle;
  handle_release_t handle_release;
  handle_dim_t handle_width;
  handle_dim_t handle_height;
  decode_image_t decode_image;
  image_release_t image_release;
  image_plane_ro_t image_plane_ro;
  image_get_dim_t image_width;
  image_get_dim_t image_height;
  ctx_get_encoder_t ctx_get_encoder;
  encoder_release_t encoder_release;
  encoder_lossy_q_t encoder_set_quality;
  image_create_t image_create;
  image_add_plane_t image_add_plane;
  image_plane_t image_plane;
  ctx_encode_t ctx_encode;
  ctx_write_file_t ctx_write_file;
};

Heif* load_heif() {
  static Heif heif;
  static bool attempted = false;
  if (attempted) return heif.dl ? &heif : nullptr;
  attempted = true;
  void* dl = dlopen("libheif.so.1", RTLD_NOW | RTLD_LOCAL);
  if (!dl) dl = dlopen("libheif.so", RTLD_NOW | RTLD_LOCAL);
  if (!dl) return nullptr;
  auto sym = [&](const char* name) { return dlsym(dl, name); };
#define SD_HEIF_LOAD(field, name, type)                       \
  heif.field = reinterpret_cast<type>(sym(name));             \
  if (!heif.field) {                                          \
    dlclose(dl);                                              \
    return nullptr;                                           \
  }
  SD_HEIF_LOAD(ctx_alloc, "heif_context_alloc", ctx_alloc_t)
  SD_HEIF_LOAD(ctx_free, "heif_context_free", ctx_free_t)
  SD_HEIF_LOAD(ctx_read_file, "heif_context_read_from_file", ctx_read_file_t)
  SD_HEIF_LOAD(ctx_primary_handle, "heif_context_get_primary_image_handle",
               ctx_primary_handle_t)
  SD_HEIF_LOAD(handle_release, "heif_image_handle_release", handle_release_t)
  SD_HEIF_LOAD(handle_width, "heif_image_handle_get_width", handle_dim_t)
  SD_HEIF_LOAD(handle_height, "heif_image_handle_get_height", handle_dim_t)
  SD_HEIF_LOAD(decode_image, "heif_decode_image", decode_image_t)
  SD_HEIF_LOAD(image_release, "heif_image_release", image_release_t)
  SD_HEIF_LOAD(image_plane_ro, "heif_image_get_plane_readonly",
               image_plane_ro_t)
  SD_HEIF_LOAD(image_width, "heif_image_get_width", image_get_dim_t)
  SD_HEIF_LOAD(image_height, "heif_image_get_height", image_get_dim_t)
  SD_HEIF_LOAD(ctx_get_encoder, "heif_context_get_encoder_for_format",
               ctx_get_encoder_t)
  SD_HEIF_LOAD(encoder_release, "heif_encoder_release", encoder_release_t)
  SD_HEIF_LOAD(encoder_set_quality, "heif_encoder_set_lossy_quality",
               encoder_lossy_q_t)
  SD_HEIF_LOAD(image_create, "heif_image_create", image_create_t)
  SD_HEIF_LOAD(image_add_plane, "heif_image_add_plane", image_add_plane_t)
  SD_HEIF_LOAD(image_plane, "heif_image_get_plane", image_plane_t)
  SD_HEIF_LOAD(ctx_encode, "heif_context_encode_image", ctx_encode_t)
  SD_HEIF_LOAD(ctx_write_file, "heif_context_write_to_file", ctx_write_file_t)
#undef SD_HEIF_LOAD
  heif.dl = dl;
  return &heif;
}

}  // namespace

extern "C" {

int sd_heif_available() { return load_heif() != nullptr; }

// Primary-image dimensions WITHOUT decoding (the metadata extractor's
// path: reading the handle's declared size costs parsing, not an HEVC
// decode). Returns 0 on success, -1 unavailable, -2 unreadable.
int32_t sd_heif_dims(const char* path, int32_t* out_w, int32_t* out_h) {
  Heif* h = load_heif();
  if (!h) return -1;
  void* ctx = h->ctx_alloc();
  if (!ctx) return -2;
  void* handle = nullptr;
  int32_t rc = -2;
  if (h->ctx_read_file(ctx, path, nullptr).code == 0 &&
      h->ctx_primary_handle(ctx, &handle).code == 0) {
    int w = h->handle_width(handle), hh = h->handle_height(handle);
    if (w > 0 && hh > 0) {
      *out_w = w;
      *out_h = hh;
      rc = 0;
    }
  }
  if (handle) h->handle_release(handle);
  h->ctx_free(ctx);
  return rc;
}

// Decode the primary image of a HEIF/AVIF file to packed RGB24.
// Returns bytes written (w*h*3) or negative: -1 unavailable, -2 decode
// failure, -3 buffer too small.
int64_t sd_heif_decode_rgb(const char* path, uint8_t* out, int64_t cap,
                           int32_t* out_w, int32_t* out_h) {
  Heif* h = load_heif();
  if (!h) return -1;
  void* ctx = h->ctx_alloc();
  if (!ctx) return -2;
  void* handle = nullptr;
  void* img = nullptr;
  int64_t rc = -2;
  int w = 0, hh = 0, stride = 0;
  const uint8_t* plane = nullptr;

  if (h->ctx_read_file(ctx, path, nullptr).code != 0) goto done;
  if (h->ctx_primary_handle(ctx, &handle).code != 0) goto done;
  // pre-decode guard on the DECLARED size (bounds the decode allocation)
  if (static_cast<int64_t>(h->handle_width(handle)) *
          h->handle_height(handle) * 3 > cap) {
    rc = -3;
    goto done;
  }
  if (h->decode_image(handle, &img, kColorspaceRGB, kChromaInterleavedRGB,
                      nullptr).code != 0)
    goto done;
  // dimensions MUST come from the decoded image, not the container's
  // declared (ispe) size — a crafted file whose header overstates the
  // dimensions would otherwise drive the row copy past the plane buffer
  w = h->image_width(img, kChannelInterleaved);
  hh = h->image_height(img, kChannelInterleaved);
  if (w <= 0 || hh <= 0) goto done;
  if (static_cast<int64_t>(w) * hh * 3 > cap) {
    rc = -3;
    goto done;
  }
  plane = h->image_plane_ro(img, kChannelInterleaved, &stride);
  if (!plane || stride < w * 3) goto done;
  for (int y = 0; y < hh; y++)
    memcpy(out + static_cast<int64_t>(y) * w * 3,
           plane + static_cast<int64_t>(y) * stride, static_cast<size_t>(w) * 3);
  *out_w = w;
  *out_h = hh;
  rc = static_cast<int64_t>(w) * hh * 3;

done:
  if (img) h->image_release(img);
  if (handle) h->handle_release(handle);
  h->ctx_free(ctx);
  return rc;
}

// Encode RGB24 to a .heic/.avif file (test fixture generator). Returns 0,
// or -1 unavailable, -4 when this libheif has no HEVC/AV1 encoder (tests
// skip), -2 other failure.
int32_t sd_heif_encode_file(const char* path, const uint8_t* rgb, int32_t w,
                            int32_t h_px, int32_t quality) {
  Heif* h = load_heif();
  if (!h) return -1;
  void* ctx = h->ctx_alloc();
  if (!ctx) return -2;
  void* enc = nullptr;
  void* img = nullptr;
  void* out_handle = nullptr;
  int32_t rc = -2;
  int stride = 0;
  uint8_t* plane = nullptr;

  if (h->ctx_get_encoder(ctx, kCompressionHEVC, &enc).code != 0 &&
      h->ctx_get_encoder(ctx, kCompressionAV1, &enc).code != 0) {
    rc = -4;
    goto done;
  }
  h->encoder_set_quality(enc, quality);
  if (h->image_create(w, h_px, kColorspaceRGB, kChromaInterleavedRGB, &img)
          .code != 0)
    goto done;
  if (h->image_add_plane(img, kChannelInterleaved, w, h_px, 8).code != 0)
    goto done;
  plane = h->image_plane(img, kChannelInterleaved, &stride);
  if (!plane) goto done;
  for (int y = 0; y < h_px; y++)
    memcpy(plane + static_cast<int64_t>(y) * stride,
           rgb + static_cast<int64_t>(y) * w * 3, static_cast<size_t>(w) * 3);
  if (h->ctx_encode(ctx, img, enc, nullptr, &out_handle).code != 0) goto done;
  if (h->ctx_write_file(ctx, path).code != 0) goto done;
  rc = 0;

done:
  if (out_handle) h->handle_release(out_handle);
  if (img) h->image_release(img);
  if (enc) h->encoder_release(enc);
  h->ctx_free(ctx);
  return rc;
}

}  // extern "C"
