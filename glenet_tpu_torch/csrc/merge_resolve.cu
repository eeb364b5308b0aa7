// Merge-resolve kernel for Hopper (sm_90a): positions and successor deltas of
// sorted query streams against a sorted per-sample id table.
//
// Replaces the Pallas TPU kernel glenet_tpu/ops/merge_kernel.py::_kernel,
// reached through resolve_sorted_queries.  Contract, per query q = queries[b, g, j]:
//   pos = left insertion index of q into ids[b]          (in [0, V])
//   dk  = clamp(ids[b][pos + k] - q, 0, 3), k = 0, 1, 2  (3 past the table)
//
// What bounds it: bytes.  Each query reads 4 B and writes 16 B, and the table
// is read once.  A search per query from scratch is bound by latency instead
// (~17 dependent L2 loads per thread), and so is one long chain per block:
// the design keeps each chain short and uses that every [b, g] query row is
// sorted.
//   - A block owns a tile of kTile consecutive queries of one row (tiles never
//     straddle rows; the ragged last tile is masked).  Lane L of warp w owns
//     queries 128 w + L + 32 k, k = 0..3, so every load and store of a warp is
//     128 contiguous bytes.
//   - Warp 0 finds the lower bounds of the tile's first and last query in
//     ids[b] with 32 probes per step, both searches in lockstep (4 dependent
//     loads for 2^17 slots): the tile's table window is [lo_first,
//     min(lo_last + 3, V)).  It issues its own query loads first.
//   - The window is staged in shared memory with 16-byte cp.async copies.
//   - Each warp narrows the window to its own 128 queries with the same
//     32-probe search, in shared memory.
//   - Each lane then runs its 4 lower-bound searches branch-free in lockstep
//     over the warp's range: a fixed trip count, no divergence, 4 loads in
//     flight, and neighbouring lanes on neighbouring banks in the last steps.
// A tile whose window exceeds kWindow slots (the query row crosses into a
// denser part of the table, or the queries are sparse) is narrowed per warp
// in global memory and staged per warp in kWindow / 8 slots; a warp whose
// range is wider still searches global memory inside it.  Both are exact,
// only slower, and counted in `stats` when it is given.  Differences are
// taken in 64 bits, because the raw shifted queries of the table builders may
// be negative or lie above the table's sentinel.  Reads stay inside the
// window even for unsorted queries (the results are then unspecified).
//
// Plain C interface, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing, does not synchronise, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 6;                     // resident blocks per SM
constexpr int kTile = 4 * kThreads;               // 4 queries per thread
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = 6144;                     // table slots in shared memory
constexpr int kWarpWindow = kWindow / kWarps;     // per warp, in wide tiles
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

struct SharedTable {  // slot p of the row is win[p - off]
  const int32_t* win;
  int off;
  __device__ __forceinline__ int32_t operator()(int p) const { return win[p - off]; }
};

struct GlobalTable {
  const int32_t* row;
  __device__ __forceinline__ int32_t operator()(int p) const { return __ldg(row + p); }
};

// One step of a warp-wide lower-bound search of q in tab[lo, hi): the 32
// lanes probe 32 slots and the range shrinks to that between the last probe
// below q and the first at or above it.  `probe` loads this lane's slot,
// `narrow` shrinks the range; a range of at most 32 slots is left to `finish`.
template <class Tab>
__device__ __forceinline__ bool probe(const Tab& tab, int lo, int hi, int32_t q) {
  const int n = hi - lo;
  return n > 32 && tab(lo + ((threadIdx.x & 31) + 1) * n / 33) < q;
}

__device__ __forceinline__ void narrow(bool below, int& lo, int& hi) {
  const int n = hi - lo;
  if (n <= 32) return;
  const int p = lo + ((threadIdx.x & 31) + 1) * n / 33;
  const int c = __popc(__ballot_sync(kFull, below));
  const int p_below = __shfl_sync(kFull, p, c > 0 ? c - 1 : 0);
  const int p_above = __shfl_sync(kFull, p, c < 32 ? c : 31);
  if (c > 0) lo = p_below + 1;
  if (c < 32) hi = p_above;
}

template <class Tab>
__device__ __forceinline__ int finish(const Tab& tab, int lo, int hi, int32_t q) {
  const int lane = threadIdx.x & 31;
  const bool below = lane < hi - lo && tab(lo + lane) < q;
  return lo + __popc(__ballot_sync(kFull, below));
}

// Lower bounds of qa and qb in tab[lo, hi), by one whole warp, the two
// searches in lockstep so that their loads overlap: 2^17 slots take 4
// dependent steps.
template <class Tab>
__device__ __forceinline__ void warp_lower_bounds(const Tab& tab, int lo, int hi, int32_t qa,
                                                  int32_t qb, int& ra, int& rb) {
  int lo_a = lo, hi_a = hi, lo_b = lo, hi_b = hi;
  while (hi_a - lo_a > 32 || hi_b - lo_b > 32) {
    const bool below_a = probe(tab, lo_a, hi_a, qa);
    const bool below_b = probe(tab, lo_b, hi_b, qb);
    narrow(below_a, lo_a, hi_a);
    narrow(below_b, lo_b, hi_b);
  }
  ra = finish(tab, lo_a, hi_a, qa);
  rb = finish(tab, lo_b, hi_b, qb);
}

__device__ __forceinline__ int32_t clamp_delta(int32_t id, int32_t q) {
  const long long d = static_cast<long long>(id) - q;
  return static_cast<int32_t>(d < 0 ? 0 : (d > 3 ? 3 : d));
}

// Resolves the warp's queries jw + lane + 32 k (k = 0..3, those below j_end)
// against `tab`, their answers lying in [lo, hi], and stores pos and the 3
// deltas.  All lanes share the range, so the four branch-free searches run
// in lockstep with a fixed trip count: no divergence, four loads in flight,
// and neighbouring lanes probe neighbouring slots in the last steps.
template <class Tab>
__device__ __forceinline__ void resolve_warp(const Tab& tab, int lo, int hi, int v,
                                             const int32_t (&q)[4], int jw, int j_end,
                                             int32_t* out_row, long long plane) {
  int pos[4] = {lo, lo, lo, lo};
  // the answer lies in [pos, pos + len - 1]; the probe never reads slot hi
  for (int len = hi - lo + 1; len > 1;) {
    const int half = len >> 1;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (tab(pos[k] + half - 1) < q[k]) pos[k] += half;
    }
    len -= half;
  }
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = jw + lane + 32 * k;
    if (j < j_end) {
      int32_t* o = out_row + j;
      o[0] = pos[k];
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const int p = pos[k] + s;
        o[(s + 1) * plane] = p < v ? clamp_delta(tab(p), q[k]) : 3;
      }
    }
  }
}

__device__ __forceinline__ void cp_async16(int32_t* smem, const int32_t* gmem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(gmem));
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
merge_resolve_kernel(const int32_t* __restrict__ ids, const int32_t* __restrict__ queries,
                     int32_t* __restrict__ out, int g, int v, int vq, int tiles_per_row,
                     long long plane, unsigned int* __restrict__ stats) {
  __shared__ __align__(16) int32_t win[kWindow + 8];
  __shared__ int bounds[2];
  const int row = blockIdx.x / tiles_per_row;  // b * G + g
  const int j0 = (blockIdx.x - row * tiles_per_row) * kTile;
  const int j_end = min(j0 + kTile, vq);
  const long long row_off = static_cast<long long>(row) * vq;
  const long long ids_off = static_cast<long long>(row / g) * v;
  const int32_t* q_row = queries + row_off;
  const GlobalTable ids_row{ids + ids_off};
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // Lane L of warp w owns queries j0 + 128 w + L + 32 k, k = 0..3: each
  // load and store of the warp is 128 contiguous bytes.
  const int jw = j0 + 128 * warp;
  int32_t q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int jq = jw + lane + 32 * k;
    q[k] = jq < j_end ? __ldg(q_row + jq) : 0;
  }
  // Warp 0 bounds the tile's table window, after its own loads are issued.
  if (warp == 0) {
    int lo_first, lo_last;
    warp_lower_bounds(ids_row, 0, v, __ldg(q_row + j0), __ldg(q_row + j_end - 1), lo_first,
                      lo_last);
    if (lane == 0) {
      bounds[0] = lo_first;
      bounds[1] = lo_last;
    }
  }

  // The first and last query of this warp's 128.
  const bool warp_active = jw < j_end;
  const int last = min(127, j_end - 1 - jw);
  const int32_t q_col = last < 32 ? q[0] : last < 64 ? q[1] : last < 96 ? q[2] : q[3];
  const int32_t qw_first = __shfl_sync(kFull, q[0], 0);
  const int32_t qw_last = __shfl_sync(kFull, q_col, last & 31);
  __syncthreads();
  const int lo_first = bounds[0];
  const int lo_last = max(bounds[1], lo_first);
  const int w = min(lo_last + 3, v) - lo_first;

  int32_t* out_row = out + row_off;
  int wlo, whi;
  if (w <= kWindow) {
    // win[s] holds flat slot f0 - shift + s: 16-byte aligned chunks in both
    // memories; the last (n & 3) slots are copied one by one.
    const long long f0 = ids_off + lo_first;
    const bool vec_ids = aligned16(ids);
    const int shift = vec_ids ? static_cast<int>(f0 & 3) : 0;
    const int32_t* src = ids + (f0 - shift);
    const int n = shift + w;
    const int n_vec = vec_ids ? n & ~3 : 0;
    for (int c = 4 * threadIdx.x; c < n_vec; c += 4 * kThreads) cp_async16(win + c, src + c);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    for (int s = n_vec + threadIdx.x; s < n; s += kThreads) win[s] = __ldg(src + s);
    __syncthreads();
    if (!warp_active) return;
    // each warp narrows the window to its own 128 queries, in shared memory
    const SharedTable tab{win, lo_first - shift};
    warp_lower_bounds(tab, lo_first, lo_last, qw_first, qw_last, wlo, whi);
    resolve_warp(tab, wlo, max(whi, wlo), v, q, jw, j_end, out_row, plane);
    return;
  }

  // Wide window: each warp narrows it to its own 128 queries in global memory
  // and stages that in its kWarpWindow slots; wider still (sparse queries),
  // it resolves from global memory inside its narrowed range.
  if (threadIdx.x == 0 && stats != nullptr) atomicAdd(stats, 1u);
  if (!warp_active) return;
  warp_lower_bounds(ids_row, lo_first, lo_last, qw_first, qw_last, wlo, whi);
  whi = max(whi, wlo);
  const int ww = min(whi + 3, v) - wlo;
  if (ww <= kWarpWindow) {
    int32_t* wwin = win + warp * kWarpWindow;
    for (int s = lane; s < ww; s += 32) wwin[s] = ids_row(wlo + s);
    __syncwarp();
    resolve_warp(SharedTable{wwin, wlo}, wlo, whi, v, q, jw, j_end, out_row, plane);
  } else {
    if (lane == 0 && stats != nullptr) atomicAdd(stats + 1, 1u);
    resolve_warp(ids_row, wlo, whi, v, q, jw, j_end, out_row, plane);
  }
}

}  // namespace

// out: (4, B, G, Vq) int32, planes pos, d0, d1, d2.  stats: null, or two
// device counters: tiles whose window exceeded the shared buffer, and groups
// of 128 queries in them that were resolved from global memory.
extern "C" int merge_resolve(const void* ids, const void* queries, void* out, long long b,
                             long long g, long long v, long long vq, void* stats,
                             void* stream) {
  if (b * g == 0 || vq == 0) return 0;
  const long long tiles = (vq + kTile - 1) / kTile;
  if (b * g * tiles > INT_MAX || vq > INT_MAX || v > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  merge_resolve_kernel<<<static_cast<unsigned>(b * g * tiles), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const int32_t*>(queries),
      static_cast<int32_t*>(out), static_cast<int>(g), static_cast<int>(v),
      static_cast<int>(vq), static_cast<int>(tiles), b * g * vq,
      static_cast<unsigned int*>(stats));
  return static_cast<int>(cudaGetLastError());
}
