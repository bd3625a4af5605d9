// Batched segmented row reduction for Hopper (sm_90a):
//
//     out[b, f, :] = sum of big[b, r, :] over rows r with fid[b, r] == f
//
// for every bucket b of a dispatch class in ONE launch. Ids outside
// [0, f_max) contribute nowhere; a family with no contributing row
// comes out as exactly 0.0f.
//
// Replaces the Pallas TPU kernel duplexumiconsensusreads_tpu/kernels/
// pallas_ssc.py:segment_gemm (body _seg_gemm_kernel), which computes
// the same reduction for one bucket as band-masked one-hot matrix
// products on the MXU, because the MXU was the TPU's fast path. It is
// not carried over block by block, and it uses no tensor cores: the
// work is one f32 add per 4 bytes read (0.25 FLOP/byte, far below the
// card's ridge), and a one-hot wgmma would sum in another order (TF32
// or 3xTF32 splits), breaking the bit-identity below.
//
// What bounds it: bytes. Every live row of big is read once, every id
// once and every element of out written once. The design aims at
// keeping enough of those bytes in flight that memory, not latency,
// sets the pace:
//
//   grid  = (column tile, family tile, bucket), CT x FT per block; the
//           wrapper picks (CT, FT) per launch from (N, f_max, C) so
//           that a class puts two blocks on each SM wherever its
//           families and columns allow (tail classes of 1-5 buckets
//           included), down to 32 columns x 1 family.
//   ids   = the block loads its bucket's ids into shared memory once,
//           16 bytes a load, and compacts the rows whose id lies in its
//           family tile into an ascending list (warp ballots and one
//           barrier). The block then walks only those rows. On the main
//           path's ids the band from a tile's first to its last row
//           holds other tiles' rows too, because the strided duplex ids
//           interleave; a first version that walked the band ran the
//           main path's class in 1.156 ms, this one in 0.999 ms
//           (chip_smoke.py on an H100 80GB HBM3 at 700 W; that version
//           also had four stages and 128 x 64 tiles). Buckets taller
//           than ID_CHUNK rows go chunk by chunk, in row order.
//   rows  = a ring of STAGES shared-memory stages of RT = 2048 / CT
//           listed rows x CT columns, filled by 16-byte cp.async (L1
//           bypassed) STAGES-1 tiles ahead of the consumer, so 2 x 8 KB
//           per block stay in flight, with three to four blocks an SM
//           (a fourth stage's shared memory leaves two blocks an SM).
//           16-byte copies need 16-byte-aligned rows: big's row stride
//           is a multiple of 4 floats (the evidence block is written
//           into a padded buffer, kernels/consensus.py), which the
//           wrapper checks.
//   adds  = thread t owns column c0 + t of the block's FT x CT
//           accumulator tile in shared memory; it walks the staged rows
//           in ascending order, UNROLL rows' values read ahead of their
//           adds, and keeps the current family's sum in a register,
//           spilling it to the tile only when the id changes.
//           No two threads touch one accumulator: no races, no atomics.
//
// Determinism: each output element is a sequence of f32 adds in
// ascending row order, starting from 0.0f, with no atomics. The result
// is a pure function of the inputs, and it is bit-identical to the
// plain version in kernels/segment_gemm.py (segment_gemm_plain), which
// adds rows in the same order. Ids need not be sorted or contiguous:
// the strided duplex ids (molecule * 2 + strand) interleave.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int STAGE_FLOATS = 2048;  // 8 KB a stage: RT = 2048 / CT rows
constexpr int STAGES = 3;           // stages in the ring
constexpr int ID_CHUNK = 4096;      // ids held in shared memory at once
constexpr int UNROLL = 8;           // staged rows read ahead of their adds

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__host__ __device__ constexpr int id_chunk_for(int n_rows) {
  return n_rows < ID_CHUNK ? (n_rows + 3) / 4 * 4 : ID_CHUNK;
}

// cp.async the rows of stage tile `tile` -- entries tile * RT on of the
// block's row list, up to n_ours -- into ring slot tile % STAGES,
// then commit the group (an empty group past the last tile keeps the
// count)
template <int CT>
__device__ __forceinline__ void load_stage(float* stage, const float* big_rows, int row_stride,
                                            const uint16_t* rows, int tile, int n_ours, int c0,
                                            int n_cols) {
  constexpr int RT = STAGE_FLOATS / CT;
  constexpr int VEC = CT / 4;  // 16-byte chunks per staged row
  const int e0 = tile * RT;
  if (e0 < n_ours) {
    float* dst = stage + (tile % STAGES) * STAGE_FLOATS;
#pragma unroll
    for (int k = threadIdx.x; k < RT * VEC; k += CT) {
      const int i = k / VEC, q = k - i * VEC;
      const int col = c0 + 4 * q;
      if (e0 + i < n_ours && col < n_cols)
        cp_async16(dst + i * CT + 4 * q, big_rows + (int64_t)rows[e0 + i] * row_stride + col);
    }
  }
  cp_async_commit();
}

template <int CT>
__global__ void __launch_bounds__(CT)
segment_gemm_kernel(const float* __restrict__ big, int64_t bucket_stride, int row_stride,
                    const int* __restrict__ fid, float* __restrict__ out, int n_rows,
                    int n_cols, int f_max, int ft) {
  constexpr int WARPS = CT / 32;
  constexpr int RT = STAGE_FLOATS / CT;
  static_assert(RT % UNROLL == 0, "a stage holds whole unrolled row groups");
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);
  float* acc = stage + STAGES * STAGE_FLOATS;
  int* s_fid = reinterpret_cast<int*>(acc + ft * CT);
  const int id_chunk = id_chunk_for(n_rows);
  uint16_t* rows = reinterpret_cast<uint16_t*>(s_fid + id_chunk);  // our rows, ascending
  int* warp_hits = reinterpret_cast<int*>(rows + id_chunk);       // WARPS ints

  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int c0 = blockIdx.x * CT;
  const int c = c0 + t;
  const int f0 = blockIdx.y * ft;
  const int f_hi = min(f0 + ft, f_max);  // exclusive end of this block's families
  const int64_t b = blockIdx.z;
  const float* big_b = big + b * bucket_stride;
  const int* fid_b = fid + b * (int64_t)n_rows;

  for (int f = 0; f < ft; ++f) acc[f * CT + t] = 0.0f;
  int cur = -1;    // the family whose running sum is in `a`
  float a = 0.0f;

  for (int k0 = 0; k0 < n_rows; k0 += id_chunk) {
    const int kn = min(id_chunk, n_rows - k0);
    __syncthreads();  // the previous chunk's ids, list and stages are consumed
    const int* src = fid_b + k0;
    int head = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      head = kn & ~3;
      const int4* src4 = reinterpret_cast<const int4*>(src);
      int4* dst4 = reinterpret_cast<int4*>(s_fid);
      for (int v = t; v < head / 4; v += CT) dst4[v] = __ldg(src4 + v);
    }
    for (int i = head + t; i < kn; i += CT) s_fid[i] = src[i];
    __syncthreads();

    // the chunk's rows of this family tile, in ascending order: each
    // warp owns a contiguous segment of rows and counts its hits 32 at
    // a time (ballot), one barrier places the segments, and each warp
    // writes its hits' row indices
    const int seg = (kn + WARPS - 1) / WARPS;
    const int s0 = min(kn, w * seg), s1 = min(kn, s0 + seg);
    int hits = 0;
    for (int i0 = s0; i0 < s1; i0 += 32) {
      const int i = i0 + lane;
      const int f = i < s1 ? s_fid[i] : -1;
      hits += __popc(__ballot_sync(0xffffffffu, f >= f0 && f < f_hi));
    }
    if (lane == 0) warp_hits[w] = hits;
    __syncthreads();
    int n_ours = 0, at = 0;
#pragma unroll
    for (int j = 0; j < WARPS; ++j) {
      at += j < w ? warp_hits[j] : 0;
      n_ours += warp_hits[j];
    }
    for (int i0 = s0; i0 < s1; i0 += 32) {
      const int i = i0 + lane;
      const int f = i < s1 ? s_fid[i] : -1;
      const bool hit = f >= f0 && f < f_hi;
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (hit) rows[at + __popc(m & ((1u << lane) - 1))] = (uint16_t)i;
      at += __popc(m);
    }
    __syncthreads();
    if (n_ours == 0) continue;  // no row of this chunk is ours (uniform)

    const int n_tiles = (n_ours + RT - 1) / RT;
    const float* big_rows = big_b + (int64_t)k0 * row_stride;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s)
      load_stage<CT>(stage, big_rows, row_stride, rows, s, n_ours, c0, n_cols);
    for (int tile = 0; tile < n_tiles; ++tile) {
      cp_async_wait<STAGES - 2>();  // this tile's copies have landed
      __syncthreads();              // ... for every thread; the slot
                                    // refilled next was consumed by all
      load_stage<CT>(stage, big_rows, row_stride, rows, tile + STAGES - 1, n_ours, c0, n_cols);
      const float* staged = stage + (tile % STAGES) * STAGE_FLOATS;
      const int e0 = tile * RT;
      const int rn = min(RT, n_ours - e0);
      // adds in ascending row order; UNROLL rows' ids and values are
      // read first, and the running sum of one family stays in a
      // register while its rows follow each other
      for (int i0 = 0; i0 < rn; i0 += UNROLL) {
        int f[UNROLL];
        float v[UNROLL];
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
          f[k] = i0 + k < rn ? s_fid[rows[e0 + i0 + k]] : -1;
          v[k] = staged[(i0 + k) * CT + t];
        }
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
          if (f[k] < 0) continue;  // past the end of the list
          if (f[k] != cur) {
            if (cur >= 0) acc[(cur - f0) * CT + t] = a;
            a = acc[(f[k] - f0) * CT + t];
            cur = f[k];
          }
          a += v[k];
        }
      }
    }
    cp_async_wait<0>();
  }
  if (cur >= 0) acc[(cur - f0) * CT + t] = a;

  if (c >= n_cols) return;
  float* out_b = out + b * (int64_t)f_max * n_cols;
  for (int f = f0; f < f_hi; ++f) out_b[(int64_t)f * n_cols + c] = acc[(f - f0) * CT + t];
}

template <int CT>
int launch(const float* big, int64_t bucket_stride, int row_stride, const int* fid, float* out,
           int n_buckets, int n_rows, int n_cols, int f_max, int ft, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)STAGES * STAGE_FLOATS + (size_t)ft * CT) +
                      (sizeof(int) + sizeof(uint16_t)) * (size_t)id_chunk_for(n_rows) +
                      sizeof(int) * (CT / 32);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        segment_gemm_kernel<CT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((n_cols + CT - 1) / CT, (f_max + ft - 1) / ft, n_buckets);
  segment_gemm_kernel<CT><<<grid, CT, smem, stream>>>(big, bucket_stride, row_stride, fid, out,
                                                      n_rows, n_cols, f_max, ft);
  return (int)cudaGetLastError();
}

}  // namespace

// big (n_buckets, n_rows, n_cols) f32 with unit column stride, a row
// stride and a bucket stride that are multiples of 4 floats, 16-byte
// aligned; fid (n_buckets, n_rows) i32 and out (n_buckets, f_max,
// n_cols) f32 contiguous -- all on the device. col_tile is 32, 64 or
// 128 columns (threads per block), fam_tile 1-64 families per block.
// Launches on `stream` and returns the launch's cudaError_t (0 = ok).
extern "C" int segment_gemm_f32(const float* big, long long bucket_stride, int row_stride,
                                const int* fid, float* out, int n_buckets, int n_rows,
                                int n_cols, int f_max, int col_tile, int fam_tile,
                                void* stream) {
  if (n_buckets <= 0 || n_rows <= 0 || n_cols <= 0 || f_max <= 0 || fam_tile <= 0 ||
      fam_tile > 64 || row_stride % 4 || bucket_stride % 4 ||
      (reinterpret_cast<uintptr_t>(big) & 15))
    return (int)cudaErrorInvalidValue;
  if (n_buckets > 65535 || (f_max + fam_tile - 1) / fam_tile > 65535)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  switch (col_tile) {
    case 32:
      return launch<32>(big, bucket_stride, row_stride, fid, out, n_buckets, n_rows, n_cols,
                        f_max, fam_tile, s);
    case 64:
      return launch<64>(big, bucket_stride, row_stride, fid, out, n_buckets, n_rows, n_cols,
                        f_max, fam_tile, s);
    case 128:
      return launch<128>(big, bucket_stride, row_stride, fid, out, n_buckets, n_rows, n_cols,
                         f_max, fam_tile, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
