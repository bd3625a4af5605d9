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
// products. It is not carried over block by block: on this card the
// reduction needs no matrix unit at all.
//
// What bounds it: bytes. Every element of big is read once and every
// element of out written once (plus 4 bytes of id per row); the only
// arithmetic is one f32 add per element of big, far below the card's
// rate. The design therefore aims at reading big once, coalesced:
//
//   grid  = (column tile, family tile, bucket); the bucket axis lives
//           inside the launch, so a class of N buckets is one launch.
//   block = CT threads; thread t owns column c0 + t of the block's
//           FT-family accumulator tile in shared memory. No two threads
//           touch one accumulator, so there are no races and no atomics.
//   loop  = the block walks its bucket's rows in ascending order, one
//           CT-row tile at a time. The tile's ids go to shared memory;
//           __syncthreads_or skips a tile none of whose ids falls in the
//           block's family range (the band test of the TPU kernel, made
//           exact). In a live tile every thread reads big[r, c] only for
//           rows whose id is in range: consecutive threads read
//           consecutive columns of one row, and each element of big is
//           read by exactly one block of the whole grid.
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

constexpr int CT = 128;  // columns per block == threads per block == rows per tile
constexpr int FT = 64;   // families per block (accumulator rows in shared memory)
constexpr int UNROLL = 4;

__global__ void __launch_bounds__(CT)
segment_gemm_kernel(const float* __restrict__ big, const int* __restrict__ fid,
                    float* __restrict__ out, int n_rows, int n_cols, int f_max) {
  __shared__ float acc[FT * CT];
  __shared__ int s_fid[CT];

  const int t = threadIdx.x;
  const int c = blockIdx.x * CT + t;
  const int f0 = blockIdx.y * FT;
  const int f_hi = min(f0 + FT, f_max);  // exclusive end of this block's families
  const int64_t b = blockIdx.z;
  const bool col_ok = c < n_cols;
  const float* big_b = big + b * (int64_t)n_rows * n_cols;
  const int* fid_b = fid + b * (int64_t)n_rows;

#pragma unroll 8
  for (int f = 0; f < FT; ++f) acc[f * CT + t] = 0.0f;

  for (int r0 = 0; r0 < n_rows; r0 += CT) {
    const int r = r0 + t;
    const int mine = r < n_rows ? fid_b[r] : -1;
    s_fid[t] = mine;
    // barrier + "does any id of this tile fall in [f0, f_hi)?"
    if (!__syncthreads_or(mine >= f0 && mine < f_hi)) continue;
    const int n_tile = min(CT, n_rows - r0);
    for (int i = 0; i < n_tile; i += UNROLL) {
      float v[UNROLL];
      int slot[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const int f = (i + k < n_tile) ? s_fid[i + k] : -1;
        const bool hit = f >= f0 && f < f_hi;
        slot[k] = hit ? f - f0 : -1;
        v[k] = (hit && col_ok) ? big_b[(int64_t)(r0 + i + k) * n_cols + c] : 0.0f;
      }
      // adds in ascending row order: loads above are issued together,
      // the accumulation order stays that of the rows
#pragma unroll
      for (int k = 0; k < UNROLL; ++k)
        if (slot[k] >= 0) acc[slot[k] * CT + t] += v[k];
    }
    __syncthreads();  // s_fid is rewritten by the next tile
  }

  if (!col_ok) return;
  float* out_b = out + b * (int64_t)f_max * n_cols;
  for (int f = f0; f < f_hi; ++f) out_b[(int64_t)f * n_cols + c] = acc[(f - f0) * CT + t];
}

}  // namespace

// big (n_buckets, n_rows, n_cols) f32, fid (n_buckets, n_rows) i32,
// out (n_buckets, f_max, n_cols) f32 -- all contiguous on the device.
// Launches on `stream` and returns the launch's cudaError_t (0 = ok).
extern "C" int segment_gemm_f32(const float* big, const int* fid, float* out,
                                int n_buckets, int n_rows, int n_cols, int f_max,
                                void* stream) {
  if (n_buckets <= 0 || n_rows <= 0 || n_cols <= 0 || f_max <= 0) return (int)cudaErrorInvalidValue;
  if (n_buckets > 65535 || (f_max + FT - 1) / FT > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((n_cols + CT - 1) / CT, (f_max + FT - 1) / FT, n_buckets);
  segment_gemm_kernel<<<grid, CT, 0, (cudaStream_t)stream>>>(big, fid, out, n_rows, n_cols, f_max);
  return (int)cudaGetLastError();
}
