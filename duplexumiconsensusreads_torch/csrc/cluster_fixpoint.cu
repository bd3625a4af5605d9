// Directional clustering for Hopper (sm_90a): grouping's min-ancestor
// fixpoint, and the whole directional-cluster step around it.
//
// It replaces no Pallas kernel. It is the port's counterpart of
// _directional_cluster in duplexumiconsensusreads_tpu/kernels/grouping.py
// (the lax.while_loop at :160, which sweeps s <- min(s, min over
// in-edges) on the device until no slot changes, at most U sweeps) and of
// the molecule-rank block of group_kernel there (:173). Two entry points:
//
//   cluster_fixpoint_i32    (kernels/cluster_fixpoint.py:propagate_min)
//       s[b, j] = min(s0[b, j], min of s0[b, i] over every slot i that
//                 reaches j along the directed edges edge[b, i, j])
//       over a given (N, U, U) bool edge grid.
//   directional_cluster_i32 (kernels/cluster_fixpoint.py:directional_cluster)
//       the unique-UMI slot table (words, pos, count) -> each slot's seed,
//       its molecule id and the bucket's molecule count, with the edges,
//       the ranks and the ids built in shared memory: no (N, U, U) grid
//       is ever written. This is what grouping runs on the card.
//
// Both run every bucket of a dispatch class in ONE launch, one block per
// bucket, and read nothing back to the host.
//
// Why the fixpoint is bit-identical to the plain Jacobi loop: it is
// unique (each slot ends at the least start key among the slots that
// reach it, itself included), every update only lowers a key to the key
// of a slot that reaches it, and a sweep in which no slot changed read
// nothing but the keys it started from, so it stopped at that fixpoint.
// So the block updates s in place (Gauss-Seidel: a sweep sees the
// updates made earlier in it), in any order, and needs no more sweeps
// than the Jacobi loop; the cap of U sweeps (JAX's `i < u`) therefore
// never stops it early either.
//
// Where the edges live: an edge joins two slots of ONE position (the
// edge test includes pos[i] == pos[j]), and the slots are numbered in
// sorted (pos, UMI) order with invalid slots (position I32_MAX) at the
// tail, so a slot's in-neighbours lie in the contiguous slot range of its
// position group: a few percent of the U x U square on the main path.
// Each block checks that pos is non-decreasing (one __syncthreads_and);
// if it is, a valid slot's range [lo, hi) comes from two binary searches
// of pos, else it is [0, U) (the full scan, exact on any input). An
// invalid slot's range is empty.
//
// The shared device code (one list build, one sweep), templated on the
// edge test:
//   1. count each slot's in-edges over its range, thread per slot,
//      UNROLL tests at a time so their loads overlap; one block scan
//      turns the counts into CSR offsets.
//   2. if the list fits its shared memory, write each slot's
//      in-neighbours into it (i16 slot numbers) and sweep over the list:
//      each thread owns a contiguous run of slots and visits them in
//      ascending order, so a chain that climbs through its run settles
//      in one sweep. Otherwise each sweep runs the edge test again over
//      the ranges, thread per slot.
//   3. stop when __syncthreads_or says no slot changed, or after U
//      sweeps.
// For cluster_fixpoint_i32 the edge test reads the grid (a warp reads 32
// neighbouring bytes of one edge row: coalesced). For
// directional_cluster_i32 it is the UMI-tools edge of
// grouping.py:_directional_cluster,
//     i -> j  iff  i != j, pos_i == pos_j, cnt_i >= count_ratio*cnt_j - 1
//                  and ham(i, j) <= max_hamming,
// with ham from the 2-bit packed words (15 codes a word, the pad codes 0
// on both sides): x = a ^ b, popc((x | x >> 1) & 0x15555555) over the W
// words.
//
// directional_cluster_i32, one block per bucket:
//   a. load the slot table (W words, pos, count: 4 (W + 2) bytes a slot)
//      into shared memory; where it does not fit beside the keys, the
//      offsets and a list of MIN_LIST entries, it is read from global
//      memory instead (L2-resident: a block reads its own 4 (W + 2) U
//      bytes, at most 384 KB at U 16384).
//   b. rank: rank_i = the number of valid slots j of i's range whose key
//      (-cnt_j, words_j) is less than slot i's (grouping.py:104-106), and
//      s0_i = rank_i * U + i; an invalid slot starts at U * U + i. The
//      plain version ranks over the whole table, this over i's range
//      (its position group when sorted). Both count keys strictly below
//      key_i among a set holding every slot that can reach i, so they
//      order any two slots of one group alike, ties included, and the
//      least (rank, slot) over a slot's ancestors -- its seed -- is the
//      same slot.
//   c. the fixpoint (1-3 above); seed_i = s_i % U.
//   d. molecule ids (group_kernel's key (pos_i, words[seed_i])):
//      firstk_i = no earlier slot of i's range has i's key; fv_i =
//      firstk_i for a valid slot. One block scan of fv gives its exclusive
//      prefix P, and n_mol = P[U]. With sorted positions every slot before
//      i's group holds a smaller key and every slot after it a larger one,
//      so mid_i = P[lo_i] + #{j in [lo_i, hi_i): fv_j, words[seed_j] <
//      words[seed_i]}; the full scan counts fv_j with key_j < key_i over
//      all slots. An invalid slot's mid is I32_MAX.
//
// What bounds it (kernels/cluster_fixpoint.py, chip_smoke.py's cluster
// phase): the table in and seed, mid and n_mol out, a few MB per class,
// against the in-group pair tests -- integer operations -- over the
// card's int32 rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 8;  // independent edge tests in flight per thread
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

// the slot range that can hold j's in-neighbours: none for an invalid
// slot (position I32_MAX), else its position group's when the positions
// are sorted, else every slot
struct SlotRange {
  const int* pos;
  int u;
  bool grouped;
  __device__ __forceinline__ void operator()(int j, int& lo, int& hi) const {
    const int p = pos[j];
    if (p == INVALID_POS) {
      lo = hi = 0;
    } else if (grouped) {
      lo = lower_bound(pos, u, p);
      hi = upper_bound(pos, u, p);
    } else {
      lo = 0;
      hi = u;
    }
  }
};

// whether pos[0, u) is non-decreasing; every thread of the block calls it
__device__ __forceinline__ bool block_sorted(const int* pos, int u) {
  bool ok = true;
  for (int j = threadIdx.x + 1; j < u; j += THREADS) ok &= pos[j - 1] <= pos[j];
  return __syncthreads_and(ok);
}

// edge(i, j) for i in [lo, hi), UNROLL tests at a time, each handed to
// f(i, edge)
template <typename E, typename F>
__device__ __forceinline__ void scan_in(const E& edge, int j, int lo, int hi, F f) {
  int i = lo;
  for (; i + UNROLL <= hi; i += UNROLL) {
    bool e[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) e[k] = edge(i + k, j);
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) f(i + k, e[k]);
  }
  for (; i < hi; ++i) f(i, edge(i, j));
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

// 1-2: each slot's in-degree over its range into CSR offsets off[0, u],
// then, if they fit list_cap entries, the in-neighbour list. Returns
// whether the list was written.
template <typename E>
__device__ bool build_in_lists(const E& edge, const SlotRange& range, int* off, uint16_t* list,
                               int u, int list_cap, int* wsum) {
  for (int j = threadIdx.x; j < u; j += THREADS) {
    int lo, hi;
    range(j, lo, hi);
    int d = 0;
    scan_in(edge, j, lo, hi, [&](int, bool e) { d += e; });
    off[j] = d;
  }
  __syncthreads();
  block_exclusive_scan(off, u, wsum);
  const bool use_list = off[u] <= list_cap;
  if (use_list) {
    for (int j = threadIdx.x; j < u; j += THREADS) {
      int lo, hi;
      range(j, lo, hi);
      int w = off[j];
      scan_in(edge, j, lo, hi, [&](int i, bool e) {
        if (e) list[w++] = (uint16_t)i;
      });
    }
    __syncthreads();
  }
  return use_list;
}

// 3: sweeps to the fixpoint, in place. Slot j is written only by the
// thread that owns it in the sweep; other threads may read its old or
// its new key, both of which are keys of slots that reach j.
template <typename E>
__device__ void sweep_to_fixpoint(const E& edge, const SlotRange& range, int* s, const int* off,
                                  const uint16_t* list, bool use_list, int u) {
  volatile int* vs = s;
  const int t = threadIdx.x;
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
        scan_in(edge, j, lo, hi, [&](int i, bool e) {
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
}

// ---------------------------------------------------------------- the grid

// the edge test of propagate_min: one byte of the bucket's (U, U) grid
struct GridEdges {
  const uint8_t* __restrict__ e;
  int u;
  __device__ __forceinline__ bool operator()(int i, int j) const {
    return e[(int64_t)i * u + j] != 0;
  }
};

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

  const int64_t b = blockIdx.x;
  for (int j = threadIdx.x; j < u; j += THREADS) {
    s[j] = s0[b * u + j];
    pos[j] = u_pos[b * u + j];
  }
  __syncthreads();
  const SlotRange range{pos, u, block_sorted(pos, u)};
  const GridEdges e{edge + b * (int64_t)u * u, u};
  const bool use_list = build_in_lists(e, range, off, list, u, list_cap, wsum);
  sweep_to_fixpoint(e, range, s, off, list, use_list, u);
  for (int j = threadIdx.x; j < u; j += THREADS) out[b * u + j] = s[j];
}

// --------------------------------------------------------- the slot table

// the UMI-tools directional edge of _directional_cluster, from the table
struct TableEdges {
  const int* __restrict__ words;  // (U, W)
  const int* __restrict__ pos;
  const int* __restrict__ cnt;
  int w, max_hamming, count_ratio;
  __device__ __forceinline__ bool operator()(int i, int j) const {
    if (i == j || pos[i] != pos[j]) return false;
    // count_ratio * cnt_j - 1 in i32, wrapping as the plain version's does
    if (cnt[i] < (int)((unsigned)count_ratio * (unsigned)cnt[j] - 1u)) return false;
    int d = 0;
    for (int k = 0; k < w; ++k) {
      const unsigned x = (unsigned)(words[i * w + k] ^ words[j * w + k]);
      d += __popc((x | x >> 1) & 0x15555555u);
    }
    return d <= max_hamming;
  }
};

// lexicographic compare of the word rows of slots a and b: <0, 0, >0
__device__ __forceinline__ int cmp_words(const int* words, int w, int a, int b) {
  for (int k = 0; k < w; ++k) {
    const int x = words[a * w + k], y = words[b * w + k];
    if (x != y) return x < y ? -1 : 1;
  }
  return 0;
}

__global__ void __launch_bounds__(THREADS)
directional_cluster_kernel(const int* __restrict__ words_g, const int* __restrict__ pos_g,
                           const int* __restrict__ cnt_g, int* __restrict__ seed_out,
                           int* __restrict__ mid_out, int* __restrict__ nmol_out, int u, int w,
                           int list_cap, int table_in_smem, int max_hamming, int count_ratio) {
  extern __shared__ int4 smem_raw[];
  __shared__ int wsum[WARPS];
  int* s = reinterpret_cast<int*>(smem_raw);
  int* off = s + u;
  int* tab = off + u + 1;

  const int t = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int* words = words_g + b * (int64_t)u * w;
  const int* pos = pos_g + b * u;
  const int* cnt = cnt_g + b * u;
  uint16_t* list = reinterpret_cast<uint16_t*>(tab);
  // a. the slot table
  if (table_in_smem) {
    int* sw = tab;
    int* sp = sw + u * w;
    int* sc = sp + u;
    for (int k = t; k < u * w; k += THREADS) sw[k] = words[k];
    for (int j = t; j < u; j += THREADS) {
      sp[j] = pos[j];
      sc[j] = cnt[j];
    }
    words = sw;
    pos = sp;
    cnt = sc;
    list = reinterpret_cast<uint16_t*>(sc + u);
  }
  __syncthreads();
  const SlotRange range{pos, u, block_sorted(pos, u)};

  // b. ranks by (-count, words) over each slot's range -> start keys
  for (int i = t; i < u; i += THREADS) {
    if (pos[i] == INVALID_POS) {
      s[i] = u * u + i;
      continue;
    }
    int lo, hi;
    range(i, lo, hi);
    const int ci = cnt[i];
    int rank = 0;
    for (int j = lo; j < hi; ++j) {
      if (pos[j] == INVALID_POS) continue;
      const int cj = cnt[j];
      rank += cj > ci || (cj == ci && cmp_words(words, w, j, i) < 0);
    }
    s[i] = rank * u + i;
  }
  __syncthreads();

  // c. the fixpoint over the table's edges, then the seeds
  const TableEdges e{words, pos, cnt, w, max_hamming, count_ratio};
  const bool use_list = build_in_lists(e, range, off, list, u, list_cap, wsum);
  sweep_to_fixpoint(e, range, s, off, list, use_list, u);
  for (int j = t; j < u; j += THREADS) {
    const int seed = s[j] % u;
    s[j] = seed;
    seed_out[b * u + j] = seed;
  }
  __syncthreads();

  // d. molecule ids: first occurrences of each (pos, words[seed]) key
  // into off, their exclusive prefix, then each slot's count of smaller
  // first keys
  for (int j = t; j < u; j += THREADS) {
    int fv = 0;
    if (pos[j] != INVALID_POS) {
      int lo, hi;
      range(j, lo, hi);
      fv = 1;
      for (int i = lo; i < j && i < hi; ++i) {
        if (pos[i] == pos[j] && cmp_words(words, w, s[i], s[j]) == 0) {
          fv = 0;
          break;
        }
      }
    }
    off[j] = fv;
  }
  __syncthreads();
  block_exclusive_scan(off, u, wsum);
  for (int j = t; j < u; j += THREADS) {
    int mid = INVALID_POS;
    if (pos[j] != INVALID_POS) {
      int lo, hi;
      range(j, lo, hi);
      mid = range.grouped ? off[lo] : 0;
      for (int i = lo; i < hi; ++i) {
        if (off[i + 1] == off[i]) continue;  // not a first key
        if (range.grouped || pos[i] == pos[j]) {
          mid += cmp_words(words, w, s[i], s[j]) < 0;
        } else {
          mid += pos[i] < pos[j];
        }
      }
    }
    mid_out[b * u + j] = mid;
  }
  if (t == 0) nmol_out[b] = off[u];
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

// words (n_buckets, u, w) i32 (2-bit packed UMIs, I32_MAX on empty
// slots), u_pos and u_cnt (n_buckets, u) i32 in; seed and mid
// (n_buckets, u) i32 and n_mol (n_buckets,) i32 out -- all contiguous on
// the device. table_in_smem says whether the table is copied into shared
// memory; list_cap is the in-neighbour list's length in i16 entries.
// Launches on `stream` and returns the launch's cudaError_t (0 = ok).
extern "C" int directional_cluster_i32(const int* words, const int* u_pos, const int* u_cnt,
                                       int* seed, int* mid, int* n_mol, int n_buckets, int u,
                                       int w, int list_cap, int table_in_smem, int max_hamming,
                                       int count_ratio, void* stream) {
  if (n_buckets <= 0 || u <= 0 || u > 16384 || w <= 0 || list_cap < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 4 * (2 * (size_t)u + 1) +
                      (table_in_smem ? 4 * (size_t)u * (w + 2) : 0) + 2 * (size_t)list_cap;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        directional_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  directional_cluster_kernel<<<n_buckets, THREADS, smem, (cudaStream_t)stream>>>(
      words, u_pos, u_cnt, seed, mid, n_mol, u, w, list_cap, table_in_smem, max_hamming,
      count_ratio);
  return (int)cudaGetLastError();
}
