// JPEG decode for the PyTorch port's data layer: libjpeg, driven from
// memory, to 8-bit RGB.
//
// The port's own copy of the JPEG half of dalle_pytorch_tpu/native/
// loader.cc (decode_jpeg, :62). The port decodes PNG and BMP with numpy
// (data/images.py) and resizes with its own copy of PIL's bilinear
// filter, so this library only turns JPEG bytes into the (H, W, 3)
// uint8 pixels PIL's Image.open(path).convert("RGB") gives: libjpeg's
// default islow IDCT and fancy upsampling, grey expanded to RGB by
// libjpeg as PIL's convert does.
//
// C ABI (ctypes, no CPython dependency):
//   dtl_jpeg_header(data, n, &w, &h, err, errlen) -> 0 | -1
//   dtl_jpeg_decode(data, n, out, w, h, err, errlen) -> 0 | -1
//     out: caller-allocated w*h*3 bytes, HWC RGB.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC loader.cc -o <lib>.so -ljpeg
// (native/build.py, into build/kernels/).

#include <csetjmp>
#include <cstdio>
#include <cstring>

#include <jpeglib.h>

namespace {

// libjpeg's default error handler exit()s: trap it with longjmp
struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jump;
  char msg[JMSG_LENGTH_MAX];
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  (*cinfo->err->format_message)(cinfo, err->msg);
  longjmp(err->jump, 1);
}

void set_err(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", msg);
}

// header only (want == nullptr) or the whole decode into want
int run(const unsigned char* data, unsigned long n, int* w, int* h,
        unsigned char* want, int ww, int wh, char* err, int errlen) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    set_err(err, errlen, jerr.msg);
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data), n);
  jpeg_read_header(&cinfo, TRUE);
  if (want == nullptr) {
    *w = cinfo.image_width;
    *h = cinfo.image_height;
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  cinfo.out_color_space = JCS_RGB;  // grey and YCbCr expand to RGB
  jpeg_start_decompress(&cinfo);
  if (int(cinfo.output_width) != ww || int(cinfo.output_height) != wh ||
      cinfo.output_components != 3) {
    set_err(err, errlen, "JPEG output size differs from its header");
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = want + size_t(cinfo.output_scanline) * ww * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // namespace

extern "C" {

int dtl_jpeg_header(const unsigned char* data, unsigned long n, int* w,
                    int* h, char* err, int errlen) {
  return run(data, n, w, h, nullptr, 0, 0, err, errlen);
}

int dtl_jpeg_decode(const unsigned char* data, unsigned long n,
                    unsigned char* out, int w, int h, char* err,
                    int errlen) {
  return run(data, n, nullptr, nullptr, out, w, h, err, errlen);
}

}  // extern "C"
