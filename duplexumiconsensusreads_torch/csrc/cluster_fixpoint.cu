// Directional clustering for Hopper (sm_90a): grouping's whole
// directional-cluster step -- the UMI-tools edges, the count ranks, the
// min-ancestor fixpoint and the molecule ids -- in one launch.
//
// It replaces no Pallas kernel. It is the port's counterpart of
// _directional_cluster in duplexumiconsensusreads_tpu/kernels/grouping.py
// (the lax.while_loop at :160, which sweeps s <- min(s, min over
// in-edges) on the device until no slot changes, at most U sweeps) and of
// the molecule-rank block of group_kernel there (:173):
//
//   directional_cluster_i32 (kernels/cluster_fixpoint.py:directional_cluster)
//       the unique-UMI slot table (words, pos, count) -> each slot's seed,
//       its molecule id and the bucket's molecule count, with the edges,
//       the ranks and the ids built in shared memory: no (N, U, U) grid
//       is ever written.
//
// Every bucket of a dispatch class runs in ONE launch, one block per
// bucket, and nothing is read back to the host.
//
// The edge (grouping.py:_directional_cluster):
//     i -> j  iff  i != j, pos_i == pos_j, cnt_i >= count_ratio*cnt_j - 1
//                  and ham(i, j) <= max_hamming,
// with ham from the 2-bit packed words (15 codes a word, the pad codes 0
// on both sides): x = a ^ b, popc((x | x >> 1) & 0x15555555) over the W
// words. An edge joins two slots of ONE position, and the slots are
// numbered in sorted (pos, UMI) order with empty slots (position
// I32_MAX) at the tail, so a slot's in-neighbours lie in the contiguous
// slot range [lo, hi) of its position group: about 100 slots of a
// bucket's 512 on the main path.
//
// What bounds it: the table in and seed, mid and n_mol out are a few MB
// a class; the in-group pair tests are ~60 M int32 operations at the
// main class (chip_smoke.py:cluster_bound), so the bound is the
// operations at the card's int32 rate, a few microseconds. What kept the
// first version of this kernel at 1.5 % of it was latency, not work: 256
// threads a block each walked its two slots' groups serially five times
// (rank, in-degree, list, first key, id), each walk behind two binary
// searches for the group's bounds, with ~17 warps an SM to hide the
// dependent shared-memory loads. This design:
//
//   1. group bounds once: each slot's [lo, hi) from one pass that marks
//      the slots starting a position group and one block scan (forward
//      max of the starts, backward min), kept in shared memory. Unsorted
//      positions give every valid slot [0, U) (the full scan, exact on
//      any input); an empty slot gets an empty range.
//   2. a warp per target slot on every pair pass: the 32 lanes test 32
//      candidates of the slot's range at once, so a slot's serial chain
//      is ceil(group / 32) steps, not the group's size:
//        rank_j  = sum popc(ballot(key_i < key_j)), key (-cnt, words)
//                  (grouping.py:104-106), over the valid slots of j's range;
//        in-degree = sum popc(ballot(edge i -> j)), one pass with the rank;
//        the ballots are kept as bitmasks (U x ceil(largest group / 32)
//        words) where the block's scratch holds them, and each thread
//        writes its slots' list entries from them, in ascending i: each
//        pair's edge is tested once. Where the masks do not fit beside
//        the list, a warp per slot tests the edges again and writes
//        entry i at off[j] + popc(ballot & lanes below);
//        first key: __any_sync over the earlier slots of j's range with
//                  j's (pos, words[seed]);
//        mid_j   = P[lo] + sum popc(ballot(first_i && (pos_i, words[seed_i])
//                  < (pos_j, words[seed_j]))) over j's range, P the block's
//                  exclusive prefix of the first-key flags (with sorted
//                  positions every slot before j's group holds a smaller
//                  key and every slot after it a larger one; the full
//                  scan has lo = 0).
//      Where the table is strictly sorted by (pos, words) -- as
//      group_kernel builds it; the bounds pass checks it -- no pair pass
//      is needed for the ids: a seed is a slot of its slot's group and its
//      own seed, so the distinct keys are the self-seeded slots, in slot
//      order, and mid_j = P[seed_j] with P the exclusive prefix of the
//      self-seed flags.
//   3. every bucket of the main class resident in one wave: 512 threads
//      a block and launch bounds of four blocks an SM, with
//      kernels/cluster_fixpoint.py:cluster_plan keeping a block's shared
//      memory at a quarter of an SM's where the table allows: 4 x 132 =
//      528 blocks at once, against 280 buckets.
//   4. the fixpoint, unchanged in what it computes: start keys s0_i =
//      rank_i * U + i (an empty slot U * U + i), then sweeps in place over
//      the CSR in-neighbour list (i16 slot numbers), a thread per slot
//      (only the slot's owner writes it), Gauss-Seidel, until
//      __syncthreads_or reports no change, capped at U sweeps; seed_i =
//      s_i % U. A bucket whose list overflows the scratch (a dense group)
//      sweeps with a warp per slot over the kept masks, or over the edge
//      test where the masks do not fit either.
//
// Why the result is bit-identical to the plain version: the fixpoint is
// unique (each slot ends at the least start key among the slots that
// reach it, itself included), every update only lowers a key to the key
// of a slot that reaches it, and a sweep in which no slot changed read
// nothing but the keys it started from, so it stopped at that fixpoint;
// so any in-place order gives the plain Jacobi loop's keys, in no more
// sweeps, and the cap of U sweeps (JAX's `i < u`) never stops it early.
// The ranks over a slot's range (the plain version ranks over the whole
// table) order any two slots of one group alike, ties included, since
// both count keys strictly below among a set holding every slot that can
// reach the slot, so the least (rank, slot) over a slot's ancestors -- its
// seed -- is the same slot.

#include <cuda_runtime.h>
#include <stdint.h>

// per-phase clock stamps of each block (scripts/cluster_phases.py): a
// build with -DDUT_CLUSTER_PHASES has thread 0 of each block stamp
// clock64() at the end of every phase; the default build has none
#ifdef DUT_CLUSTER_PHASES
constexpr int N_STAMPS = 16;  // a block's stamp row, in u64
#define STAMP(k, v) \
  do { if (stamps && threadIdx.x == 0) stamps[blockIdx.x * N_STAMPS + (k)] = (v); } while (0)
#else
#define STAMP(k, v) do { } while (0)
#endif
#define CLOCK_STAMP(k) STAMP(k, (unsigned long long)clock64())

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
// the blocks an SM keeps registers for: four blocks of 512 threads fill
// an SM's 2048, 32 registers a thread
constexpr int MIN_BLOCKS = 4;
constexpr int INVALID_POS = 0x7fffffff;  // u_pos of an empty table slot
constexpr unsigned FULL = 0xffffffffu;
// the most dynamic shared memory a launch may ask for
// (kernels/cluster_fixpoint.py:SMEM_LIMIT). It is the kernel's limit on
// every launch, whatever the launch asks: threads launching tables of
// other sizes at once would otherwise race on the function's attribute,
// and a launch could find it lowered below what it asks (cudaError 1)
constexpr int SMEM_LIMIT = 231424;

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
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[w] = x;
  __syncthreads();
  if (w == 0) {
    int v = lane < WARPS ? wsum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, v, o);
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

// the slot table a block reads (shared or global memory); WC > 0 fixes
// the UMI's word count at compile time
template <int WC>
struct Table {
  const int* words;  // (U, W)
  const int* pos;
  const int* cnt;
  int w_rt;
  __device__ __forceinline__ int w() const { return WC > 0 ? WC : w_rt; }
  __device__ __forceinline__ const int* row(int i) const { return words + i * w(); }
};

// the words a pass compares its candidates against: in registers where
// W is fixed at compile time, else read from the row
template <int WC>
struct Row {
  int v[WC > 0 ? WC : 1];
  const int* p;
  __device__ __forceinline__ Row(const int* row) : p(row) {
#pragma unroll
    for (int k = 0; k < (WC > 0 ? WC : 1); ++k) v[k] = WC > 0 ? row[k] : 0;
  }
  __device__ __forceinline__ int operator[](int k) const { return WC > 0 ? v[k] : p[k]; }
};

// a < b and a == b, lexicographic over the words (signed, as the plain
// compare), and the packed Hamming distance; no branches
template <int WC>
__device__ __forceinline__ void compare_rows(const int* a, const Row<WC>& b, int w, bool& lt,
                                             bool& eq, int& ham) {
  const int n = WC > 0 ? WC : w;
  lt = false;
  eq = true;
  ham = 0;
#pragma unroll
  for (int k = 0; k < n; ++k) {
    const int x = a[k], y = b[k];
    lt |= eq & (x < y);
    eq &= x == y;
    const unsigned d = (unsigned)(x ^ y);
    ham += __popc((d | d >> 1) & 0x15555555u);
  }
}

__device__ __forceinline__ void range_of(const int* lohi, int j, int& lo, int& hi) {
  const int r = lohi[j];
  lo = r & 0xffff;
  hi = r >> 16;
}

// the in-edge ballot of target slot j over the candidates base + lane
// (the edge test again, where the masks were not kept)
template <int WC>
__device__ __forceinline__ unsigned edge_ballot(const Table<WC>& tb, int j, int base, int hi,
                                                int max_hamming, int count_ratio) {
  const int i = base + (threadIdx.x & 31);
  const bool in = i < hi;
  const int c = in ? i : j;
  const Row<WC> wj(tb.row(j));
  bool lt, eq;
  int ham;
  compare_rows(tb.row(c), wj, tb.w(), lt, eq, ham);
  const int thresh = (int)((unsigned)count_ratio * (unsigned)tb.cnt[j] - 1u);
  return __ballot_sync(FULL, in & (i != j) & (tb.pos[c] == tb.pos[j]) &
                                 (tb.cnt[c] >= thresh) & (ham <= max_hamming));
}

// 2. a warp per target slot j over its range: the rank and the in-edges,
// 32 candidates a step, the edge ballots kept where they fit. A lane past
// the range reads slot j instead and counts nothing. SORTED: the range is
// j's position group, every slot of it valid and at j's position.
template <bool SORTED, int WC>
__device__ __forceinline__ void rank_and_indegree(const Table<WC>& tb, const int* lohi, int u,
                                                  int max_hamming, int count_ratio, int* s,
                                                  int* off, uint32_t* masks, int mask_words,
                                                  bool keep_masks) {
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < u; j += WARPS) {
    int lo, hi;
    range_of(lohi, j, lo, hi);
    int rank = 0, deg = 0;
    if (lo != hi) {
      const int cj = tb.cnt[j], pj = tb.pos[j];
      // count_ratio * cnt_j - 1 in i32, wrapping as the plain version's does
      const int thresh = (int)((unsigned)count_ratio * (unsigned)cj - 1u);
      const Row<WC> wj(tb.row(j));
      for (int base = lo, k = 0; base < hi; base += 32, ++k) {
        const int i = base + lane;
        const bool in = i < hi;
        const int c = in ? i : j;
        const int ci = tb.cnt[c];
        const int pi = SORTED ? pj : tb.pos[c];
        bool lt, eq;
        int ham;
        compare_rows(tb.row(c), wj, tb.w(), lt, eq, ham);
        const bool less = in & (pi != INVALID_POS) & ((ci > cj) | ((ci == cj) & lt));
        const unsigned em = __ballot_sync(FULL, in & (i != j) & (pi == pj) & (ci >= thresh) &
                                                    (ham <= max_hamming));
        rank += __popc(__ballot_sync(FULL, less));
        deg += __popc(em);
        if (keep_masks && lane == 0) masks[j * mask_words + k] = em;
      }
    }
    if (lane == 0) {
      s[j] = lo != hi ? rank * u + j : u * u + j;
      off[j] = deg;
    }
  }
}

// 5a. first occurrences of each key (pos_j, words[seed_j]) over j's
// range, a warp per slot: into first[j]
template <bool SORTED, int WC>
__device__ __forceinline__ void first_keys(const Table<WC>& tb, const int* s, const int* lohi,
                                           int u, int* first) {
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < u; j += WARPS) {
    int lo, hi;
    range_of(lohi, j, lo, hi);
    bool first_key = lo != hi;
    if (first_key) {
      const int pj = tb.pos[j];
      const Row<WC> kj(tb.row(s[j]));
      for (int base = lo; base < j && first_key; base += 32) {
        const int i = base + lane;
        const bool in = i < j;
        const int c = in ? i : j;
        bool lt, eq;
        int ham;
        compare_rows(tb.row(s[c]), kj, tb.w(), lt, eq, ham);
        first_key = !__any_sync(FULL, in & (SORTED || tb.pos[c] == pj) & eq);
      }
    }
    if (lane == 0) first[j] = first_key;
  }
}

// 5b. each slot's molecule id, a warp per slot: the first keys before its
// range (prefix P) plus the smaller first keys in it
template <bool SORTED, int WC>
__device__ __forceinline__ void molecule_ids(const Table<WC>& tb, const int* s, const int* lohi,
                                             int u, const int* prefix, int* mid_out) {
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < u; j += WARPS) {
    int lo, hi;
    range_of(lohi, j, lo, hi);
    int mid = INVALID_POS;
    if (lo != hi) {
      const int pj = tb.pos[j];
      const Row<WC> kj(tb.row(s[j]));
      mid = prefix[lo];
      for (int base = lo; base < hi; base += 32) {
        const int i = base + lane;
        const bool in = i < hi;
        const int c = in ? i : j;
        const int pi = SORTED ? pj : tb.pos[c];
        bool lt, eq;
        int ham;
        compare_rows(tb.row(s[c]), kj, tb.w(), lt, eq, ham);
        mid += __popc(__ballot_sync(FULL, in & (prefix[c + 1] != prefix[c]) &
                                              (pi == pj ? lt : pi < pj)));
      }
    }
    if (lane == 0) mid_out[j] = mid;
  }
}

template <int WC, bool IN_SMEM>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
directional_cluster_kernel(const int* __restrict__ words_g, const int* __restrict__ pos_g,
                           const int* __restrict__ cnt_g, int* __restrict__ seed_out,
                           int* __restrict__ mid_out, int* __restrict__ nmol_out, int u,
                           int w_rt, int scratch_bytes, int max_hamming, int count_ratio,
                           unsigned long long* stamps) {
  extern __shared__ int4 smem_raw[];
  __shared__ int wsum[WARPS];
  __shared__ int wlast[WARPS], wfirst[WARPS];
  __shared__ int max_group;
  const int w = WC > 0 ? WC : w_rt;
  int* s = reinterpret_cast<int*>(smem_raw);  // keys, then seeds
  int* off = s + u;                           // CSR offsets, then first keys' prefix
  int* lohi = off + u + 1;                    // each slot's range: lo | hi << 16
  int* tab = lohi + u;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t b = blockIdx.x;
  const int* pos_in = pos_g + b * u;
  const int* words_in = words_g + b * (int64_t)u * w;
  const int* cnt_in = cnt_g + b * u;
#ifdef DUT_CLUSTER_PHASES
  if (stamps && t == 0) {
    unsigned smid;
    unsigned long long gt;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(gt));
    stamps[b * N_STAMPS + 11] = smid;
    stamps[b * N_STAMPS + 12] = gt;
  }
#endif
  CLOCK_STAMP(0);

  // 1. the slot table into shared memory (where planned) and, from the
  // positions in global memory meanwhile, each thread's run of slots:
  // whether it is sorted, its last and first group starts
  if (t == 0) max_group = 0;
  Table<WC> tb{words_in, pos_in, cnt_in, w_rt};
  char* scratch = reinterpret_cast<char*>(tab);
  if (IN_SMEM) {
    int* sw = tab;
    int* sp = sw + u * w;
    int* sc = sp + u;
    for (int k = t; k < u * w; k += THREADS) sw[k] = words_in[k];
    for (int j = t; j < u; j += THREADS) {
      sp[j] = pos_in[j];
      sc[j] = cnt_in[j];
    }
    tb = Table<WC>{sw, sp, sc, w_rt};
    scratch = reinterpret_cast<char*>(sc + u);
  }
  const int chunk = (u + THREADS - 1) / THREADS;
  const int j0 = min(u, t * chunk), j1 = min(u, j0 + chunk);
  bool ok = true, unique = true;
  int last = -1, first = u;
  for (int j = j0; j < j1; ++j) {
    const int p = pos_in[j];
    const int q = j > 0 ? pos_in[j - 1] : p;
    ok &= q <= p;
    if (j == 0 || q != p) {
      last = j;
      first = min(first, j);
    } else if (p != INVALID_POS) {  // words strictly rising within a group
      bool lt = false, eq = true;
      for (int k = 0; k < w; ++k) {
        const int x = words_in[(j - 1) * w + k], y = words_in[j * w + k];
        lt |= eq & (x < y);
        eq &= x == y;
      }
      unique &= lt;
    }
  }
  // forward max of the last starts, backward min of the first starts:
  // within the warp by shuffles, across warps through shared memory
  int fwd = last, bwd = first;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, fwd, o);
    const int z = __shfl_down_sync(FULL, bwd, o);
    if (lane >= o) fwd = max(fwd, y);
    if (lane + o < 32) bwd = min(bwd, z);
  }
  if (lane == 31) wlast[warp] = fwd;
  if (lane == 0) wfirst[warp] = bwd;
  const bool grouped = __syncthreads_and(ok);
  int lo_in = __shfl_up_sync(FULL, fwd, 1);
  int hi_in = __shfl_down_sync(FULL, bwd, 1);
  if (lane == 0) lo_in = -1;
  if (lane == 31) hi_in = u;
  for (int k = 0; k < warp; ++k) lo_in = max(lo_in, wlast[k]);
  for (int k = warp + 1; k < WARPS; ++k) hi_in = min(hi_in, wfirst[k]);
  // each slot's range: its group's [lo, hi) when sorted, else [0, U);
  // none for an empty slot. The largest group sizes the masks.
  int big = 0;
  for (int j = j1 - 1; j >= j0; --j) {  // hi: the next start after j
    lohi[j] = hi_in;
    if (j == 0 || tb.pos[j - 1] != tb.pos[j]) hi_in = j;
  }
  for (int j = j0; j < j1; ++j) {  // lo: the last start up to j
    const int p = tb.pos[j];
    if (j == 0 || tb.pos[j - 1] != p) lo_in = j;
    int lo = lo_in, hi = lohi[j];
    if (!grouped) {
      lo = 0;
      hi = u;
    }
    if (p == INVALID_POS) lo = hi = 0;
    big = max(big, hi - lo);
    lohi[j] = lo | hi << 16;
  }
  big = __reduce_max_sync(FULL, big);
  if (lane == 0) atomicMax(&max_group, big);
  // sorted by (pos, words) with no key twice, as group_kernel builds the
  // table: a group's key order is its slot order (step 5)
  const bool strict = __syncthreads_and(unique) && grouped;
  CLOCK_STAMP(1);

  // 2. the ranks and in-edges (rank_and_indegree)
  const int mask_words = (max_group + 31) / 32;
  const int mask_bytes = u * mask_words * 4;
  const bool keep_masks = mask_bytes <= scratch_bytes;
  uint32_t* masks = reinterpret_cast<uint32_t*>(scratch);
  if (grouped)
    rank_and_indegree<true>(tb, lohi, u, max_hamming, count_ratio, s, off, masks, mask_words,
                            keep_masks);
  else
    rank_and_indegree<false>(tb, lohi, u, max_hamming, count_ratio, s, off, masks, mask_words,
                             keep_masks);
  __syncthreads();
  CLOCK_STAMP(2);
  block_exclusive_scan(off, u, wsum);
  CLOCK_STAMP(3);

  // 3. the in-neighbour list: after the masks, where both fit, each
  // thread writing its own slots' entries from their masks (no pair is
  // tested again); else over the whole scratch, a warp per slot testing
  // the edges again; else none (the sweeps below read the masks or test
  // the edges)
  const int n_edges = off[u];
  const bool from_masks = keep_masks && 2 * n_edges <= scratch_bytes - mask_bytes;
  const bool use_list = from_masks || 2 * n_edges <= scratch_bytes;
  uint16_t* list = reinterpret_cast<uint16_t*>(scratch + (from_masks ? mask_bytes : 0));
  STAMP(14, use_list | keep_masks << 1 | from_masks << 2 | strict << 3);
  STAMP(15, n_edges);
  if (from_masks) {
    for (int j = j0; j < j1; ++j) {
      int lo, hi;
      range_of(lohi, j, lo, hi);
      int at = off[j];
      for (int base = lo, k = 0; base < hi; base += 32, ++k) {
        for (unsigned m = masks[j * mask_words + k]; m; m &= m - 1)
          list[at++] = (uint16_t)(base + __ffs(m) - 1);
      }
    }
    __syncthreads();
  } else if (use_list) {
    const unsigned below = (1u << lane) - 1;
    for (int j = warp; j < u; j += WARPS) {
      int lo, hi;
      range_of(lohi, j, lo, hi);
      int at = off[j];
      for (int base = lo; base < hi; base += 32) {
        const unsigned em = edge_ballot(tb, j, base, hi, max_hamming, count_ratio);
        if (em >> lane & 1) list[at + __popc(em & below)] = (uint16_t)(base + lane);
        at += __popc(em);
      }
    }
    __syncthreads();
  }
  CLOCK_STAMP(4);

  // 4. sweeps to the fixpoint, in place: slot j is written only by its
  // owner (a thread over the list, a warp's lane 0 otherwise); others
  // may read its old or its new key, both keys of slots that reach j
  volatile int* vs = s;
  int sweeps = 0;
  while (sweeps < u) {
    ++sweeps;
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
      for (int j = warp; j < u; j += WARPS) {
        int lo, hi;
        range_of(lohi, j, lo, hi);
        int m = 0x7fffffff;
        for (int base = lo, k = 0; base < hi; base += 32, ++k) {
          const unsigned em = keep_masks
                                  ? masks[j * mask_words + k]
                                  : edge_ballot(tb, j, base, hi, max_hamming, count_ratio);
          if (em >> lane & 1) m = min(m, vs[base + lane]);
        }
        m = __reduce_min_sync(FULL, m);
        if (lane == 0 && m < vs[j]) {
          vs[j] = m;
          changed = 1;
        }
      }
    }
    if (!__syncthreads_or(changed)) break;
  }
  STAMP(10, sweeps);
  CLOCK_STAMP(5);
  for (int j = t; j < u; j += THREADS) {
    const int seed = s[j] % u;
    s[j] = seed;
    seed_out[b * u + j] = seed;
  }
  __syncthreads();
  CLOCK_STAMP(6);

  // 5. molecule ids, group_kernel's key (pos_j, words[seed_j]), each
  // distinct key counted once, ids by key order
  if (strict) {
    // a slot's seed is a slot of its group, and a seed is its own seed:
    // the distinct keys are the valid self-seeded slots, in slot order,
    // so mid_j is the count of self-seeded slots below seed_j
    for (int j = t; j < u; j += THREADS) off[j] = tb.pos[j] != INVALID_POS && s[j] == j;
    __syncthreads();
    CLOCK_STAMP(7);
    block_exclusive_scan(off, u, wsum);
    CLOCK_STAMP(8);
    for (int j = t; j < u; j += THREADS)
      mid_out[b * u + j] = tb.pos[j] != INVALID_POS ? off[s[j]] : INVALID_POS;
  } else {
    // first occurrences over each slot's range into off, their exclusive
    // prefix, then each slot's count of smaller first keys in its range
    if (grouped)
      first_keys<true>(tb, s, lohi, u, off);
    else
      first_keys<false>(tb, s, lohi, u, off);
    __syncthreads();
    CLOCK_STAMP(7);
    block_exclusive_scan(off, u, wsum);
    CLOCK_STAMP(8);
    if (grouped)
      molecule_ids<true>(tb, s, lohi, u, off, mid_out + b * u);
    else
      molecule_ids<false>(tb, s, lohi, u, off, mid_out + b * u);
  }
  if (t == 0) nmol_out[b] = off[u];
#ifdef DUT_CLUSTER_PHASES
  __syncthreads();
  CLOCK_STAMP(9);
  if (stamps && t == 0) {
    unsigned long long gt;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(gt));
    stamps[b * N_STAMPS + 13] = gt;
  }
#endif
}

size_t cluster_smem(int u, int w, int scratch_bytes, int table_in_smem) {
  return 4 * (3 * (size_t)u + 1) + (table_in_smem ? 4 * (size_t)u * (w + 2) : 0) +
         (size_t)scratch_bytes;
}

// the kernel for w words (fixed at 1-3) and the table's place
template <int WC, bool IN_SMEM>
auto kernel_for() {
  return directional_cluster_kernel<WC, IN_SMEM>;
}

using KernelFn = void (*)(const int*, const int*, const int*, int*, int*, int*, int, int, int,
                          int, int, unsigned long long*);

KernelFn pick(int w, int table_in_smem) {
  switch (w) {
    case 1: return table_in_smem ? kernel_for<1, true>() : kernel_for<1, false>();
    case 2: return table_in_smem ? kernel_for<2, true>() : kernel_for<2, false>();
    case 3: return table_in_smem ? kernel_for<3, true>() : kernel_for<3, false>();
    default: return table_in_smem ? kernel_for<0, true>() : kernel_for<0, false>();
  }
}

int launch_cluster(const int* words, const int* u_pos, const int* u_cnt, int* seed, int* mid,
                   int* n_mol, int n_buckets, int u, int w, int scratch_bytes, int table_in_smem,
                   int max_hamming, int count_ratio, unsigned long long* stamps, void* stream) {
  if (n_buckets <= 0 || u <= 0 || u > 16384 || w <= 0 || scratch_bytes < 0)
    return (int)cudaErrorInvalidValue;
  const KernelFn kern = pick(w, table_in_smem);
  const size_t smem = cluster_smem(u, w, scratch_bytes, table_in_smem);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (e != cudaSuccess) return (int)e;
  kern<<<n_buckets, THREADS, smem, (cudaStream_t)stream>>>(
      words, u_pos, u_cnt, seed, mid, n_mol, u, w, scratch_bytes, max_hamming, count_ratio,
      stamps);
  return (int)cudaGetLastError();
}

}  // namespace

// words (n_buckets, u, w) i32 (2-bit packed UMIs, I32_MAX on empty
// slots), u_pos and u_cnt (n_buckets, u) i32 in; seed and mid
// (n_buckets, u) i32 and n_mol (n_buckets,) i32 out -- all contiguous on
// the device. table_in_smem says whether the table is copied into shared
// memory; scratch_bytes is the shared memory a block has past its slot
// arrays and table for the edge masks and the in-neighbour list
// (kernels/cluster_fixpoint.py:cluster_plan). Launches on `stream` and
// returns the launch's cudaError_t (0 = ok).
extern "C" int directional_cluster_i32(const int* words, const int* u_pos, const int* u_cnt,
                                       int* seed, int* mid, int* n_mol, int n_buckets, int u,
                                       int w, int scratch_bytes, int table_in_smem,
                                       int max_hamming, int count_ratio, void* stream) {
  return launch_cluster(words, u_pos, u_cnt, seed, mid, n_mol, n_buckets, u, w, scratch_bytes,
                        table_in_smem, max_hamming, count_ratio, nullptr, stream);
}

// how many blocks of directional_cluster_i32 at w words one SM holds at
// once with the table in shared memory and `smem` bytes of dynamic
// shared memory (0 if none)
extern "C" int directional_cluster_blocks_per_sm(int w, int smem) {
  const KernelFn kern = pick(w, 1);
  if (smem > SMEM_LIMIT ||
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT) !=
          cudaSuccess)
    return 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, THREADS, smem) != cudaSuccess)
    return 0;
  return blocks;
}

#ifdef DUT_CLUSTER_PHASES
static const char PHASE_NAMES[] =
    "table_and_bounds,rank_and_indegree,indegree_scan,list,sweeps,seeds,first_keys,"
    "first_keys_scan,ids";

// the same launch with the stamps: (n_buckets, N_STAMPS) u64 on the
// device. Row b: [0] clock64() at the block's start, [k] at the end of
// phase k (1 <= k <= 9, named by directional_cluster_phase_names), [10]
// the fixpoint's sweeps, [11] the SM, [12] / [13] %globaltimer at the
// start and the end (ns), [14] the fixpoint's mode (bit 0: the list was
// used, bit 1: the edge masks were kept, bit 2: the list was written
// from them), [15] the bucket's in-group edges
extern "C" int directional_cluster_i32_phases(const int* words, const int* u_pos,
                                              const int* u_cnt, int* seed, int* mid, int* n_mol,
                                              int n_buckets, int u, int w, int scratch_bytes,
                                              int table_in_smem, int max_hamming,
                                              int count_ratio, void* stamps, void* stream) {
  return launch_cluster(words, u_pos, u_cnt, seed, mid, n_mol, n_buckets, u, w, scratch_bytes,
                        table_in_smem, max_hamming, count_ratio,
                        (unsigned long long*)stamps, stream);
}

extern "C" const char* directional_cluster_phase_names() { return PHASE_NAMES; }
#endif
