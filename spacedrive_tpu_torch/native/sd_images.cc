// The image codecs of the port's thumbnailer: JPEG and PNG decoded into
// tightly packed RGB8, and RGB8 encoded as WebP, over the system's libjpeg,
// libpng and libwebp (the caller binds it with ctypes.CDLL).
//
// A copy of spacedrive_tpu/native/sd_images.cc, unchanged in what it does:
//
//   sd_image_decode_rgb: sniff the magic bytes, then decode to RGB8. JPEG
//     uses libjpeg's DCT-space scale_num/8 downscaling, so a large photo
//     never decodes at full size when the caller wants a thumbnail-sized
//     buffer (max_edge); PNG decodes at full size (it has no cheap
//     in-decode scaling) and the caller reduces it on the host.
//   sd_image_encode_webp: RGB8 -> WebP at the caller's quality.
//
// Buffers are the caller's numpy arrays, except the WebP output, which
// libwebp allocates and sd_webp_free releases.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread sd_images.cc -ljpeg -lpng
// -lwebp (native/__init__.py).

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <jpeglib.h>
#include <png.h>
#include <webp/encode.h>

namespace {

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// returns bytes written to out (w*h*3) or -1
int decode_jpeg(FILE* fh, uint8_t* out, int64_t capacity, int max_edge,
                int32_t* w, int32_t* h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fh);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  // DCT-space downscale: pick the largest 1/8..8/8 that still covers
  // max_edge (free antialiasing + bounded memory for huge photos)
  if (max_edge > 0) {
    unsigned edge = cinfo.image_width > cinfo.image_height
                        ? cinfo.image_width : cinfo.image_height;
    unsigned num = 8;
    while (num > 1 && (edge * (num - 1)) / 8 >= static_cast<unsigned>(max_edge))
      num--;
    cinfo.scale_num = num;
    cinfo.scale_denom = 8;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int64_t row_bytes = static_cast<int64_t>(cinfo.output_width) * 3;
  if (row_bytes * cinfo.output_height > capacity) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + static_cast<int64_t>(cinfo.output_scanline) * row_bytes;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  *w = static_cast<int32_t>(cinfo.output_width);
  *h = static_cast<int32_t>(cinfo.output_height);
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return static_cast<int>(row_bytes * *h);
}

int decode_png(FILE* fh, uint8_t* out, int64_t capacity,
               int32_t* w, int32_t* h) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING,
                                           nullptr, nullptr, nullptr);
  if (png == nullptr) return -1;
  png_infop info = png_create_info_struct(png);
  if (info == nullptr) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return -1;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -1;
  }
  png_init_io(png, fh);
  png_read_info(png, info);
  png_uint_32 width = png_get_image_width(png, info);
  png_uint_32 height = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);
  // normalize every variant to 8-bit RGB
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);  // composite-free drop is fine for previews
  png_set_interlace_handling(png);  // Adam7 needs multi-pass reads
  png_read_update_info(png, info);
  const int64_t row_bytes = static_cast<int64_t>(width) * 3;
  if (row_bytes * height > capacity) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -1;
  }
  // png_read_image handles interlaced and linear layouts uniformly
  png_bytep* rows = static_cast<png_bytep*>(
      std::malloc(sizeof(png_bytep) * height));
  if (rows == nullptr) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -1;
  }
  for (png_uint_32 y = 0; y < height; y++) rows[y] = out + y * row_bytes;
  png_read_image(png, rows);
  std::free(rows);
  png_destroy_read_struct(&png, &info, nullptr);
  *w = static_cast<int32_t>(width);
  *h = static_cast<int32_t>(height);
  return static_cast<int>(row_bytes * height);
}

}  // namespace

extern "C" {

// Decode path into out (capacity bytes). Returns bytes written (w*h*3),
// 0 for unsupported format, -1 on decode error / too-large image.
int64_t sd_image_decode_rgb(const char* path, uint8_t* out, int64_t capacity,
                            int32_t max_edge, int32_t* w, int32_t* h) {
  FILE* fh = std::fopen(path, "rb");
  if (fh == nullptr) return -1;
  uint8_t magic[8] = {0};
  size_t got = std::fread(magic, 1, sizeof(magic), fh);
  std::rewind(fh);
  int64_t rc = 0;
  if (got >= 3 && magic[0] == 0xFF && magic[1] == 0xD8 && magic[2] == 0xFF) {
    rc = decode_jpeg(fh, out, capacity, max_edge, w, h);
  } else if (got >= 8 && std::memcmp(magic, "\x89PNG\r\n\x1a\n", 8) == 0) {
    rc = decode_png(fh, out, capacity, w, h);
  }
  std::fclose(fh);
  return rc;
}

// RGB8 → WebP. Returns malloc'd buffer via *out_ptr (sd_webp_free it);
// 0 length on failure.
uint64_t sd_image_encode_webp(const uint8_t* rgb, int32_t w, int32_t h,
                              float quality, uint8_t** out_ptr) {
  uint8_t* webp = nullptr;
  size_t n = WebPEncodeRGB(rgb, w, h, w * 3, quality, &webp);
  *out_ptr = webp;
  return static_cast<uint64_t>(n);
}

void sd_webp_free(uint8_t* p) { WebPFree(p); }

}  // extern "C"
