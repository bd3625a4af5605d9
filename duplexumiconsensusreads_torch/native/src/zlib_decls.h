// The zlib entry points bamloader.cpp calls, declared for a host that
// has the zlib runtime (libz.so.1, which Python's own zlib module
// loads) but not its development header. zlib's ABI for these calls
// has been stable across the 1.x series: the z_stream layout below is
// zlib.h's, and inflateInit2_/deflateInit2_ check only the major
// version digit and sizeof(z_stream). Built with -DDUT_ZLIB_DECLS.

#ifndef DUT_ZLIB_DECLS_H
#define DUT_ZLIB_DECLS_H

extern "C" {

typedef unsigned char Bytef;
typedef unsigned int uInt;
typedef unsigned long uLong;
typedef void* voidpf;
typedef voidpf (*alloc_func)(voidpf opaque, uInt items, uInt size);
typedef void (*free_func)(voidpf opaque, voidpf address);
struct internal_state;

typedef struct z_stream_s {
  Bytef* next_in;
  uInt avail_in;
  uLong total_in;
  Bytef* next_out;
  uInt avail_out;
  uLong total_out;
  char* msg;
  struct internal_state* state;
  alloc_func zalloc;
  free_func zfree;
  voidpf opaque;
  int data_type;
  uLong adler;
  uLong reserved;
} z_stream;
typedef z_stream* z_streamp;

int inflateInit2_(z_streamp strm, int windowBits, const char* version,
                  int stream_size);
int inflate(z_streamp strm, int flush);
int inflateEnd(z_streamp strm);
int deflateInit2_(z_streamp strm, int level, int method, int windowBits,
                  int memLevel, int strategy, const char* version,
                  int stream_size);
int deflate(z_streamp strm, int flush);
int deflateEnd(z_streamp strm);
uLong crc32(uLong crc, const Bytef* buf, uInt len);

}  // extern "C"

#define ZLIB_VERSION "1.2.11"
#define Z_NULL 0
#define Z_OK 0
#define Z_STREAM_END 1
#define Z_FINISH 4
#define Z_DEFLATED 8
#define Z_DEFAULT_STRATEGY 0

#define inflateInit2(strm, windowBits) \
  inflateInit2_((strm), (windowBits), ZLIB_VERSION, (int)sizeof(z_stream))
#define deflateInit2(strm, level, method, windowBits, memLevel, strategy) \
  deflateInit2_((strm), (level), (method), (windowBits), (memLevel),    \
                (strategy), ZLIB_VERSION, (int)sizeof(z_stream))

#endif  // DUT_ZLIB_DECLS_H
