// Native JPEG decoding for the data/eval loaders.
//
// Replaces the reference's jpeg4py/cv2 image loaders
// (lib/train/data/image_loader.py:15-100) with a direct libjpeg decoder:
// no Python-object overhead per frame, releases the GIL for the whole
// decode (called through ctypes), writes RGB8 straight into a caller-owned
// numpy buffer that is copied to the device.
//
// Decodes from a file path or from bytes in memory (the HTTP service's
// request bodies, cli/serve.py).
//
// Build: g++ -O3 -shared -fPIC jpeg_loader.cc -ljpeg -o _jpeg_loader.so

#include <cstdio>
#include <cstring>
#include <csetjmp>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// One decode from a file (f) or a buffer (data, size): the dimensions
// only when out is null, else RGB8 into out (capacity cap bytes). Returns
// 0 on success, -2 on a decode error, -3 if out is too small.
int decode(FILE* f, const unsigned char* data, unsigned long size, unsigned char* out,
           long cap, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  if (f) {
    jpeg_stdio_src(&cinfo, f);
  } else {
    jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data), size);
  }
  jpeg_read_header(&cinfo, TRUE);
  if (!out) {
    *h = static_cast<int>(cinfo.image_height);
    *w = static_cast<int>(cinfo.image_width);
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int width = static_cast<int>(cinfo.output_width);
  const int height = static_cast<int>(cinfo.output_height);
  const int stride = width * 3;
  if (static_cast<long>(stride) * height > cap) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = out + static_cast<long>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *h = height;
  *w = width;
  return 0;
}

int decode_file(const char* path, unsigned char* out, long cap, int* h, int* w) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  const int rc = decode(f, nullptr, 0, out, cap, h, w);
  fclose(f);
  return rc;
}

}  // namespace

extern "C" {

// Returns 0 on success; fills *h, *w with image dimensions.
int uvl_jpeg_dims(const char* path, int* h, int* w) {
  return decode_file(path, nullptr, 0, h, w);
}

// Decodes `path` as RGB8 into `out` (capacity `cap` bytes).
// Returns 0 on success, fills *h/*w; -1 file error, -2 decode error,
// -3 buffer too small.
int uvl_jpeg_decode(const char* path, unsigned char* out, long cap,
                    int* h, int* w) {
  return decode_file(path, out, cap, h, w);
}

// The same two for `size` bytes of JPEG at `data`.
int uvl_jpeg_dims_mem(const unsigned char* data, long size, int* h, int* w) {
  return decode(nullptr, data, static_cast<unsigned long>(size), nullptr, 0, h, w);
}

int uvl_jpeg_decode_mem(const unsigned char* data, long size, unsigned char* out,
                        long cap, int* h, int* w) {
  return decode(nullptr, data, static_cast<unsigned long>(size), out, cap, h, w);
}

}  // extern "C"
