// Native BAM data loader: multithreaded BGZF decompression + BAM record
// field extraction into caller-preallocated (NumPy) buffers.
//
// This is the framework's native IO runtime — the role pysam/htslib
// plays for the reference's per-family Python loop (BASELINE.json
// north_star), rebuilt for the device pipeline's needs: it emits exactly
// the struct-of-arrays layout ReadBatch wants (padded seq/qual code
// matrices, flags, positions, RX strings) so the Python side does zero
// per-record work. The pure-Python codec (io/bgzf.py, io/bam.py) is
// the portable reference implementation it is tested against.
//
// Exposed via a C ABI for ctypes (no pybind11 in this image).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#ifdef DUT_ZLIB_DECLS
#include "zlib_decls.h"  // no zlib.h on this host: see that file
#else
#include <zlib.h>
#endif

// Parse one BGZF block header at `off`: fills compressed size and
// uncompressed size. Returns 0, or -1 on malformed input.
static int parse_bgzf_block(const uint8_t* data, long n, long off,
                            long* bsize_out, uint32_t* isize_out) {
  if (off + 18 > n || data[off] != 0x1f || data[off + 1] != 0x8b) return -1;
  if (!(data[off + 3] & 4)) return -1;  // no FEXTRA -> not BGZF
  uint16_t xlen;
  std::memcpy(&xlen, data + off + 10, 2);
  long bsize = -1;
  long p = off + 12, xend = p + xlen;
  if (xend > n) return -1;
  while (p + 4 <= xend) {
    uint8_t si1 = data[p], si2 = data[p + 1];
    uint16_t slen;
    std::memcpy(&slen, data + p + 2, 2);
    if (si1 == 66 && si2 == 67) {
      if (slen != 2 || p + 6 > xend) return -1;
      uint16_t bs;
      std::memcpy(&bs, data + p + 4, 2);
      bsize = (long)bs + 1;
      break;
    }
    p += 4 + slen;
  }
  if (bsize < 12 + 6 + 8 || off + bsize > n) return -1;
  std::memcpy(isize_out, data + off + bsize - 4, 4);
  *bsize_out = bsize;
  return 0;
}

extern "C" {

// ---------------------------------------------------------------- BGZF

// Scan BGZF blocks: returns block count, fills (optional) arrays of
// compressed offset/size and cumulative uncompressed offset.
// Returns -1 on malformed input.
long dut_bgzf_scan(const uint8_t* data, long n, long* c_off, long* c_size,
                   long* u_off) {
  long off = 0, count = 0, total_u = 0;
  while (off < n) {
    long bsize;
    uint32_t isize;
    if (parse_bgzf_block(data, n, off, &bsize, &isize) != 0) return -1;
    if (c_off) c_off[count] = off;
    if (c_size) c_size[count] = bsize;
    if (u_off) u_off[count] = total_u;
    total_u += isize;
    count++;
    off += bsize;
  }
  return count;
}

// Total uncompressed size (for buffer allocation).
long dut_bgzf_usize(const uint8_t* data, long n) {
  long off = 0, total = 0;
  while (off < n) {
    long bsize;
    uint32_t isize;
    if (parse_bgzf_block(data, n, off, &bsize, &isize) != 0) return -1;
    total += isize;
    off += bsize;
  }
  return total;
}

// Decompress all blocks (n_threads-way parallel) into out (size out_cap).
// Returns bytes written or -1.
long dut_bgzf_decompress(const uint8_t* data, long n, uint8_t* out,
                         long out_cap, int n_threads) {
  long n_blocks = dut_bgzf_scan(data, n, nullptr, nullptr, nullptr);
  if (n_blocks < 0) return -1;
  std::vector<long> c_off(n_blocks), c_size(n_blocks), u_off(n_blocks);
  dut_bgzf_scan(data, n, c_off.data(), c_size.data(), u_off.data());
  long total = 0;
  for (long i = 0; i < n_blocks; i++) {
    uint32_t isize;
    std::memcpy(&isize, data + c_off[i] + c_size[i] - 4, 4);
    total += isize;
  }
  if (total > out_cap) return -1;

  std::atomic<long> next{0};
  std::atomic<bool> failed{false};
  auto worker = [&]() {
    for (;;) {
      long i = next.fetch_add(1);
      if (i >= n_blocks || failed.load()) return;
      uint16_t xlen;
      std::memcpy(&xlen, data + c_off[i] + 10, 2);
      const uint8_t* src = data + c_off[i] + 12 + xlen;
      long src_len = c_size[i] - 12 - xlen - 8;
      uint32_t isize;
      std::memcpy(&isize, data + c_off[i] + c_size[i] - 4, 4);
      z_stream zs{};
      if (inflateInit2(&zs, -15) != Z_OK) { failed = true; return; }
      zs.next_in = const_cast<uint8_t*>(src);
      zs.avail_in = (uInt)src_len;
      zs.next_out = out + u_off[i];
      zs.avail_out = (uInt)isize;
      int rc = inflate(&zs, Z_FINISH);
      inflateEnd(&zs);
      if (!((rc == Z_STREAM_END) || (rc == Z_OK && zs.avail_out == 0)) ||
          zs.total_out != isize) {
        failed = true;
        return;
      }
    }
  };
  int nt = n_threads > 0 ? n_threads : 1;
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; t++) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  if (failed.load()) return -1;
  return total;
}

// BGZF payload cap per block (htslib's choice: leaves headroom so even
// incompressible payloads fit the format's 65536 compressed-block cap
// as one stored-mode deflate sub-block).
static const long kBgzfPayload = 65280;
// Per-block scratch/compacted-output slot: 18-byte BGZF header + worst
// case deflate of 65280 (stored: 5 + 65280) + crc/isize trailer.
static const long kBgzfSlot = 65536;

// Required output capacity for dut_bgzf_compress over n input bytes.
long dut_bgzf_compress_bound(long n) {
  long blocks = n <= 0 ? 0 : (n + kBgzfPayload - 1) / kBgzfPayload;
  return blocks * kBgzfSlot;
}

static long deflate_block(const uint8_t* src, long len, uint8_t* dst,
                          int level) {
  // Deflate one payload into dst+18 (raw stream), returning the TOTAL
  // BGZF block size, or -1. Falls back to stored mode if the
  // compressed form would overflow the 65536 block cap.
  for (int attempt = 0; attempt < 2; attempt++) {
    z_stream zs{};
    int lvl = attempt == 0 ? level : 0;
    if (deflateInit2(&zs, lvl, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY) != Z_OK)
      return -1;
    zs.next_in = const_cast<uint8_t*>(src);
    zs.avail_in = (uInt)len;
    zs.next_out = dst + 18;
    zs.avail_out = (uInt)(kBgzfSlot - 18 - 8);
    int rc = deflate(&zs, Z_FINISH);
    long clen = (long)zs.total_out;
    deflateEnd(&zs);
    if (rc != Z_STREAM_END) continue;  // overflow: retry stored
    long bsize = 18 + clen + 8;
    if (bsize > 65536) continue;
    // gzip header with BC FEXTRA subfield carrying (bsize - 1)
    dst[0] = 0x1f; dst[1] = 0x8b; dst[2] = 8; dst[3] = 4;
    std::memset(dst + 4, 0, 5);  // mtime + xfl
    dst[9] = 0xff;               // OS unknown
    dst[10] = 6; dst[11] = 0;    // XLEN
    dst[12] = 66; dst[13] = 67; dst[14] = 2; dst[15] = 0;
    uint16_t bs16 = (uint16_t)(bsize - 1);
    std::memcpy(dst + 16, &bs16, 2);
    uint32_t crc = crc32(0L, Z_NULL, 0);
    crc = crc32(crc, src, (uInt)len);
    uint32_t isize = (uint32_t)len;
    std::memcpy(dst + 18 + clen, &crc, 4);
    std::memcpy(dst + 18 + clen + 4, &isize, 4);
    return bsize;
  }
  return -1;
}

// Compress data into a BGZF block stream (no EOF marker), n_threads
// parallel. out must have dut_bgzf_compress_bound(n) capacity.
// Returns bytes written, or -1.
long dut_bgzf_compress(const uint8_t* data, long n, uint8_t* out,
                       long out_cap, int level, int n_threads) {
  long n_blocks = n <= 0 ? 0 : (n + kBgzfPayload - 1) / kBgzfPayload;
  if (out_cap < n_blocks * kBgzfSlot) return -1;
  std::vector<long> bsizes(n_blocks, -1);
  std::atomic<long> next{0};
  std::atomic<bool> failed{false};
  auto worker = [&]() {
    for (;;) {
      long i = next.fetch_add(1);
      if (i >= n_blocks || failed.load()) return;
      long s = i * kBgzfPayload;
      long len = (s + kBgzfPayload <= n) ? kBgzfPayload : n - s;
      long bs = deflate_block(data + s, len, out + i * kBgzfSlot, level);
      if (bs < 0) { failed = true; return; }
      bsizes[i] = bs;
    }
  };
  int nt = n_threads > 0 ? n_threads : 1;
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; t++) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  if (failed.load()) return -1;
  // compact the fixed slots into a contiguous stream (in place, left
  // to right: the write cursor never passes the read cursor)
  long w = 0;
  for (long i = 0; i < n_blocks; i++) {
    if (w != i * kBgzfSlot)
      std::memmove(out + w, out + i * kBgzfSlot, bsizes[i]);
    w += bsizes[i];
  }
  return w;
}

// ----------------------------------------------------------------- BAM

// Walk the record chain from `off`: count complete records (up to
// max_records) using only the block_size prefixes, no field parsing.
// Sets *end_off to the byte offset just past the last complete record.
// Returns the record count, or -1 on a malformed block_size. The
// streaming reader uses this to slice whole-record byte runs off its
// rolling buffer without a per-record Python loop. rec_off, when
// non-null (capacity >= max_records), receives each record's offset —
// the linear indexer's per-record walk.
long dut_bam_chain_offsets(const uint8_t* data, long n, long off,
                           long max_records, long* end_off, long* rec_off) {
  long count = 0;
  while (count < max_records && off + 4 <= n) {
    int32_t bsz;
    std::memcpy(&bsz, data + off, 4);
    if (bsz < 33) { *end_off = off; return -1; }  // report the bad record
    if (off + 4 + (long)bsz > n) break;  // trailing partial record
    if (rec_off) rec_off[count] = off;
    off += 4 + bsz;
    count++;
  }
  *end_off = off;
  return count;
}

long dut_bam_chain(const uint8_t* data, long n, long off, long max_records,
                   long* end_off) {
  return dut_bam_chain_offsets(data, n, off, max_records, end_off, nullptr);
}

// Scan decompressed BAM: locate end of header, count records, find max
// l_seq and max RX length. Fills rec_off (record start offsets, incl.
// the 4-byte block_size field) when non-null (must have capacity from a
// prior counting call). Returns record count, or -1 on malformed data.
long dut_bam_scan(const uint8_t* data, long n, long* header_end, int* l_max,
                  int* rx_max, long* rec_off) {
  if (n < 12 || std::memcmp(data, "BAM\x01", 4) != 0) return -1;
  int32_t l_text;
  std::memcpy(&l_text, data + 4, 4);
  if (l_text < 0 || 8 + (long)l_text + 4 > n) return -1;
  long off = 8 + (long)l_text;
  int32_t n_ref;
  std::memcpy(&n_ref, data + off, 4);
  if (n_ref < 0) return -1;
  off += 4;
  for (int32_t r = 0; r < n_ref; r++) {
    if (off + 4 > n) return -1;
    int32_t l_name;
    std::memcpy(&l_name, data + off, 4);
    if (l_name < 1 || off + 4 + (long)l_name + 4 > n) return -1;
    off += 4 + l_name + 4;
  }
  if (header_end) *header_end = off;

  long count = 0;
  int lmax = 0, rxmax = 0;
  while (off < n) {
    if (off + 4 > n) return -1;
    int32_t bsz;
    std::memcpy(&bsz, data + off, 4);
    long rec_start = off;
    long rec_end = off + 4 + bsz;
    // 32 fixed bytes + >=1 NUL-terminated read-name byte: the minimum
    // true record is 37 bytes total, which io/native_reader.py relies
    // on when sizing its offsets buffer at len(data)//37.
    if (bsz < 33 || rec_end > n) return -1;
    if (rec_off) rec_off[count] = rec_start;
    const uint8_t* r = data + off + 4;
    uint8_t l_rn = r[8];
    if (l_rn < 1) return -1;
    uint16_t n_cig;
    std::memcpy(&n_cig, r + 12, 2);
    int32_t l_seq;
    std::memcpy(&l_seq, r + 16, 4);
    if (l_seq < 0) return -1;
    if (l_seq > lmax) lmax = l_seq;
    // aux region: after name, cigar, seq, qual
    long aux = off + 4 + 32 + l_rn + 4L * n_cig + (l_seq + 1) / 2 + l_seq;
    if (aux > rec_end) return -1;  // fixed fields overrun the record
    while (aux + 3 <= rec_end) {
      uint8_t t1 = data[aux], t2 = data[aux + 1], typ = data[aux + 2];
      aux += 3;
      long vlen;
      switch (typ) {
        case 'A': case 'c': case 'C': vlen = 1; break;
        case 's': case 'S': vlen = 2; break;
        case 'i': case 'I': case 'f': vlen = 4; break;
        case 'Z': case 'H': {
          long e = aux;
          while (e < rec_end && data[e] != 0) e++;
          if (e >= rec_end) return -1;  // unterminated string
          if (t1 == 'R' && t2 == 'X' && typ == 'Z') {
            int len = (int)(e - aux);
            if (len > rxmax) rxmax = len;
          }
          vlen = e - aux + 1;
          break;
        }
        case 'B': {
          if (aux + 5 > rec_end) return -1;
          uint8_t sub = data[aux];
          uint32_t cnt;
          std::memcpy(&cnt, data + aux + 1, 4);
          int esz = (sub == 'c' || sub == 'C') ? 1
                    : (sub == 's' || sub == 'S') ? 2
                    : (sub == 'i' || sub == 'I' || sub == 'f') ? 4 : -1;
          if (esz < 0) return -1;
          vlen = 5 + (long)cnt * esz;
          break;
        }
        default: return -1;
      }
      if (vlen < 0 || aux + vlen > rec_end) return -1;
      aux += vlen;
    }
    count++;
    off = rec_end;
  }
  if (l_max) *l_max = lmax;
  if (rx_max) *rx_max = rxmax;
  return count;
}

static const uint8_t kNibbleToCode[16] = {4, 0, 1, 4, 2, 4, 4, 4,
                                          3, 4, 4, 4, 4, 4, 4, 4};

// FNV-1a64 over the raw BAM cigar op words — the per-read CIGAR
// signature the modal-CIGAR input filter groups on. The Python codec
// computes the identical hash over its re-packed op words.
static uint64_t fnv1a64(const uint8_t* p, long len) {
  uint64_t h = 0xcbf29ce484222325ULL;
  for (long i = 0; i < len; i++) {
    h ^= p[i];
    h *= 0x100000001b3ULL;
  }
  return h;
}

// Fill caller-allocated arrays from record offsets. seq gets framework
// base codes padded with 5 (BASE_PAD); qual padded with 0; rx gets the
// raw RX:Z characters zero-padded to rx_cap; cig_hash gets the FNV-1a64
// CIGAR signature (0 for cigar-less records). Parallel over records.
int dut_bam_fill(const uint8_t* data, long n, const long* rec_off,
                 long n_records, int l_cap, int rx_cap, int n_threads,
                 uint16_t* flags, int32_t* ref_id, int32_t* pos,
                 int32_t* next_ref_id, int32_t* next_pos, int32_t* lseq,
                 uint8_t* seq, uint8_t* qual, uint8_t* rx,
                 uint64_t* cig_hash) {
  std::atomic<long> next{0};
  std::atomic<bool> failed{false};
  const long kChunk = 1024;
  auto worker = [&]() {
    for (;;) {
      long start = next.fetch_add(kChunk);
      if (start >= n_records || failed.load()) return;
      long end = start + kChunk < n_records ? start + kChunk : n_records;
      for (long i = start; i < end; i++) {
        long off = rec_off[i];
        int32_t bsz;
        std::memcpy(&bsz, data + off, 4);
        long rec_end = off + 4 + bsz;
        const uint8_t* r = data + off + 4;
        int32_t rid, p0, l_seq, nrid, npos;
        std::memcpy(&rid, r, 4);
        std::memcpy(&p0, r + 4, 4);
        uint8_t l_rn = r[8];
        uint16_t n_cig, flag;
        std::memcpy(&n_cig, r + 12, 2);
        std::memcpy(&flag, r + 14, 2);
        std::memcpy(&l_seq, r + 16, 4);
        std::memcpy(&nrid, r + 20, 4);
        std::memcpy(&npos, r + 24, 4);
        flags[i] = flag;
        ref_id[i] = rid;
        pos[i] = p0;
        next_ref_id[i] = nrid;
        next_pos[i] = npos;
        lseq[i] = l_seq;
        if (l_seq > l_cap) { failed = true; return; }
        cig_hash[i] = n_cig ? fnv1a64(r + 32 + l_rn, 4L * n_cig) : 0;
        const uint8_t* sp = r + 32 + l_rn + 4L * n_cig;
        uint8_t* srow = seq + (long)i * l_cap;
        std::memset(srow, 5, l_cap);  // BASE_PAD
        for (int32_t b = 0; b < l_seq; b++) {
          uint8_t nib = (b & 1) ? (sp[b >> 1] & 0xF) : (sp[b >> 1] >> 4);
          srow[b] = kNibbleToCode[nib];
        }
        const uint8_t* qp = sp + (l_seq + 1) / 2;
        uint8_t* qrow = qual + (long)i * l_cap;
        std::memset(qrow, 0, l_cap);
        if (l_seq > 0 && qp[0] == 0xFF) {
          // quality absent
        } else {
          std::memcpy(qrow, qp, l_seq);
        }
        // aux walk for RX (records were bounds-validated by dut_bam_scan,
        // but stay defensive: any overrun marks failure, never reads OOB)
        uint8_t* xrow = rx + (long)i * rx_cap;
        std::memset(xrow, 0, rx_cap);
        long aux = (qp - data) + l_seq;
        while (aux + 3 <= rec_end) {
          uint8_t t1 = data[aux], t2 = data[aux + 1], typ = data[aux + 2];
          aux += 3;
          long vlen;
          switch (typ) {
            case 'A': case 'c': case 'C': vlen = 1; break;
            case 's': case 'S': vlen = 2; break;
            case 'i': case 'I': case 'f': vlen = 4; break;
            case 'Z': case 'H': {
              long e = aux;
              while (e < rec_end && data[e] != 0) e++;
              if (e >= rec_end) { failed = true; return; }
              if (t1 == 'R' && t2 == 'X' && typ == 'Z') {
                long len = e - aux;
                if (len > rx_cap) { failed = true; return; }
                std::memcpy(xrow, data + aux, len);
              }
              vlen = e - aux + 1;
              break;
            }
            case 'B': {
              if (aux + 5 > rec_end) { failed = true; return; }
              uint8_t sub = data[aux];
              uint32_t cnt;
              std::memcpy(&cnt, data + aux + 1, 4);
              int esz = (sub == 'c' || sub == 'C') ? 1
                        : (sub == 's' || sub == 'S') ? 2
                        : (sub == 'i' || sub == 'I' || sub == 'f') ? 4 : -1;
              if (esz < 0) { failed = true; return; }
              vlen = 5 + (long)cnt * esz;
              break;
            }
            default: failed = true; return;
          }
          if (vlen < 0 || aux + vlen > rec_end) { failed = true; return; }
          aux += vlen;
        }
      }
    }
  };
  int nt = n_threads > 0 ? n_threads : 1;
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; t++) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return failed.load() ? -1 : 0;
}

}  // extern "C"
