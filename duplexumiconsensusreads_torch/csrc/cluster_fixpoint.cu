// Directional-cluster fixpoint for Hopper (sm_90a):
//
//     s[b, j] = min(s0[b, j], min of s0[b, i] over every slot i that
//               reaches j along the directed edges edge[b, i, j])
//
// for every bucket b of a dispatch class in ONE launch, with nothing
// read back: grouping's min-ancestor propagation, which gives each
// unique-UMI slot its cluster seed (kernels/grouping.py).
//
// It replaces no Pallas kernel. It is the port's counterpart of the
// lax.while_loop of duplexumiconsensusreads_tpu/kernels/grouping.py:160
// (_directional_cluster), which sweeps s <- min(s, min over in-edges)
// on the device until no slot changes, at most U sweeps. PyTorch has no
// loop on the device: the plain version (kernels/cluster_fixpoint.py)
// checks for a change on the host once per sweep, so the thread that
// dispatches a class waits on the card. Here each block runs its
// bucket to its own fixpoint and the host never waits.
//
// Why the result is bit-identical to the plain loop: the fixpoint is
// unique (each slot ends at the least start key among the slots that
// reach it, itself included), every update only lowers a key to the key
// of a slot that reaches it, and a sweep in which no slot changed read
// nothing but the keys it started from, so it stopped at that fixpoint.
// So the block updates s in place (Gauss-Seidel: a sweep sees the
// updates made earlier in it), in any order, and needs no more sweeps
// than the Jacobi loop; the cap of U sweeps (JAX's `i < u`) therefore
// never stops it early either.
//
// What bounds it: bytes. The work is a min over the in-group edge
// entries, a few integer operations per byte; the bytes it must move
// are every in-group entry of edge once, plus s0, u_pos in and s out.
// An edge joins two slots of ONE position (grouping.py ANDs
// u_pos[i] == u_pos[j] into the grid), and the slots are numbered in
// sorted (pos, UMI) order with invalid slots at the tail, so a slot's
// in-neighbours lie in the contiguous slot range of its position group:
// a few percent of the U x U grid on the main path. Invalid slots (at
// position I32_MAX) have no edges at all. The design:
//
//   grid  = one block per bucket, on grid x (no 65,535 cap); 256 threads.
//   smem  = s, u_pos and CSR offsets (i32, 12 bytes a slot) and an i16
//           in-neighbour list.
//   1. load s0 and u_pos; check that u_pos is non-decreasing (one
//      __syncthreads_and). If it is, each valid slot's range [lo, hi)
//      comes from two binary searches of u_pos in shared memory; if
//      not, the range is [0, U) (the full scan, exact on any input that
//      keeps the contract). An invalid slot's range is empty.
//   2. count each slot's in-edges over its range, thread per slot so a
//      warp reads 32 neighbouring bytes of one edge row (coalesced),
//      UNROLL rows at a time so the loads overlap; one block scan turns
//      the counts into list offsets.
//   3. if the list fits its shared memory, write each slot's
//      in-neighbours into it (a second read of the same bytes, from L2),
//      and sweep over the list: each thread owns a contiguous run of
//      slots and visits them in ascending order, so a chain that climbs
//      through its run settles in one sweep. Otherwise sweep over the
//      edge grid's in-group ranges, thread per slot (coalesced).
//   4. stop when __syncthreads_or says no slot changed, or after U
//      sweeps; write s.
//
// So device memory sees the in-group edge entries once (twice through
// L2 on the list path), and the sweeps run out of shared memory: the
// scan is of each slot's position-group range, not of all U slots, and
// there is no host sync at all.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 8;  // independent edge loads in flight per thread
constexpr int INVALID_POS = 0x7fffffff;  // u_pos of an empty table slot

__device__ __forceinline__ int lower_bound(const int* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int upper_bound(const int* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// the edge bytes col[i * u] for i in [lo, hi) -- a column of the grid --
// UNROLL loads at a time, each handed to f(i, nonzero)
template <typename F>
__device__ __forceinline__ void scan_column(const uint8_t* __restrict__ col, int u, int lo, int hi,
                                            F f) {
  int i = lo;
  for (; i + UNROLL <= hi; i += UNROLL) {
    uint8_t e[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) e[k] = col[(int64_t)(i + k) * u];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) f(i + k, e[k] != 0);
  }
  for (; i < hi; ++i) f(i, col[(int64_t)i * u] != 0);
}

// exclusive scan of a[0, n) in place, the total into a[n]; every thread
// of the block calls it
__device__ void block_exclusive_scan(int* a, int n, int* wsum) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int chunk = (n + THREADS - 1) / THREADS;
  const int j0 = min(n, t * chunk), j1 = min(n, j0 + chunk);
  int sum = 0;
  for (int j = j0; j < j1; ++j) sum += a[j];
  int x = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[w] = x;
  __syncthreads();
  if (w == 0) {
    int v = lane < WARPS ? wsum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    if (lane < WARPS) wsum[lane] = v;
  }
  __syncthreads();
  int run = x - sum + (w > 0 ? wsum[w - 1] : 0);
  for (int j = j0; j < j1; ++j) {
    const int d = a[j];
    a[j] = run;
    run += d;
  }
  if (t == THREADS - 1) a[n] = run;
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
cluster_fixpoint_kernel(const uint8_t* __restrict__ edge, const int* __restrict__ s0,
                        const int* __restrict__ u_pos, int* __restrict__ out, int u,
                        int list_cap) {
  extern __shared__ int4 smem_raw[];
  __shared__ int wsum[WARPS];
  int* s = reinterpret_cast<int*>(smem_raw);
  int* pos = s + u;
  int* off = pos + u;
  uint16_t* list = reinterpret_cast<uint16_t*>(off + u + 1);

  const int t = threadIdx.x;
  const int64_t b = blockIdx.x;
  const uint8_t* edge_b = edge + b * (int64_t)u * u;
  for (int j = t; j < u; j += THREADS) {
    s[j] = s0[b * u + j];
    pos[j] = u_pos[b * u + j];
  }
  __syncthreads();
  bool ok = true;
  for (int j = t + 1; j < u; j += THREADS) ok &= pos[j - 1] <= pos[j];
  const bool grouped = __syncthreads_and(ok);
  // the slot range that can hold j's in-neighbours: none for an invalid
  // slot (position I32_MAX), else its position group's
  auto range = [&](int j, int& lo, int& hi) {
    if (pos[j] == INVALID_POS) {
      lo = hi = 0;
    } else if (grouped) {
      lo = lower_bound(pos, u, pos[j]);
      hi = upper_bound(pos, u, pos[j]);
    } else {
      lo = 0;
      hi = u;
    }
  };

  // 2. in-degree over each slot's range, then list offsets
  for (int j = t; j < u; j += THREADS) {
    int lo, hi;
    range(j, lo, hi);
    int d = 0;
    scan_column(edge_b + j, u, lo, hi, [&](int, bool e) { d += e; });
    off[j] = d;
  }
  __syncthreads();
  block_exclusive_scan(off, u, wsum);
  const bool use_list = off[u] <= list_cap;

  // 3. the in-neighbour list, slot by slot
  if (use_list) {
    for (int j = t; j < u; j += THREADS) {
      int lo, hi;
      range(j, lo, hi);
      int w = off[j];
      scan_column(edge_b + j, u, lo, hi, [&](int i, bool e) {
        if (e) list[w++] = (uint16_t)i;
      });
    }
    __syncthreads();
  }

  // 4. sweeps to the fixpoint, in place. Slot j is written only by the
  // thread that owns it in the sweep; other threads may read its old or
  // its new key, both of which are keys of slots that reach j.
  volatile int* vs = s;
  const int chunk = (u + THREADS - 1) / THREADS;
  const int j0 = min(u, t * chunk), j1 = min(u, j0 + chunk);
  for (int sweep = 0; sweep < u; ++sweep) {
    int changed = 0;
    if (use_list) {
      for (int j = j0; j < j1; ++j) {
        const int start = vs[j];
        int m = start;
        const int e1 = off[j + 1];
        for (int e = off[j]; e < e1; ++e) m = min(m, vs[list[e]]);
        if (m < start) {
          vs[j] = m;
          changed = 1;
        }
      }
    } else {
      for (int j = t; j < u; j += THREADS) {
        int lo, hi;
        range(j, lo, hi);
        const int start = vs[j];
        int m = start;
        scan_column(edge_b + j, u, lo, hi, [&](int i, bool e) {
          if (e) m = min(m, vs[i]);
        });
        if (m < start) {
          vs[j] = m;
          changed = 1;
        }
      }
    }
    if (!__syncthreads_or(changed)) break;
  }
  for (int j = t; j < u; j += THREADS) out[b * u + j] = s[j];
}

}  // namespace

// edge (n_buckets, u, u) bool as bytes, s0 and u_pos (n_buckets, u) i32,
// out (n_buckets, u) i32 -- all contiguous on the device. list_cap is
// the in-neighbour list's length in i16 entries (0: sweep over the edge
// grid). Launches on `stream` and returns the launch's cudaError_t
// (0 = ok).
extern "C" int cluster_fixpoint_i32(const uint8_t* edge, const int* s0, const int* u_pos,
                                    int* out, int n_buckets, int u, int list_cap,
                                    void* stream) {
  if (n_buckets <= 0 || u <= 0 || u > 32768 || list_cap < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = 12 * (size_t)u + 4 + 2 * (size_t)list_cap;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cluster_fixpoint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cluster_fixpoint_kernel<<<n_buckets, THREADS, smem, (cudaStream_t)stream>>>(
      edge, s0, u_pos, out, u, list_cap);
  return (int)cudaGetLastError();
}
