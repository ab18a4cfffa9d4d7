// stream_ceiling: the device-memory stream probes, one kernel template over
// the table mix.
//
// A [rows, 128] f32 table `v` and, by mix, a second [rows, 128] table `c`,
// cut into tiles of `tile_rows` rows.  For tile t and column j:
//     f32i32  s[t][j] = sum_rows(v)[j] + float(sum_rows(c)[j])  (int32 c,
//                       the int32 sum converted once)
//     f32f32  s[t][j] = sum_rows(v)[j] + sum_rows(c)[j]         (f32 c)
//     f32     s[t][j] = sum_rows(v)[j]                          (no c)
//     f32i16  s[t][j] = sum_rows(v)[j] + (c[0][j] > 0 ? v[0][j] : 0)
//                       (int16 c; only the tile's row 0 enters the value)
// written into 8 output rows per tile: out is [rows / tile_rows * 8, 128]
// f32, rows 8t .. 8t + 7 all s[t].  The whole computation is repeated
// `reps` times inside one launch (pass after pass over every tile, as the
// reference's grid runs), so a time per pass is the delta of two launches
// with different `reps`, as the reference times it.
//
// Replaces, all of one function on the TPU (a Pallas grid of (reps, tiles)
// with a per-tile output block of 8 rows):
//   bench.py:136 stream_ceiling (f32i32, 4096-row tiles of two [2^18, 128]
//     tables: the kernel bench's probe);
//   scripts/kstream.py:61 make_stream (the four mixes, 1024-8192-row tiles);
//   scripts/kprobe.py:54 stream_bench (f32i32, one pass over [2^19, 128],
//     64-4096-row tiles);
//   scripts/chaintime.py:104 make_stream (f32i32, k passes, 256-4096 rows).
//
// What bounds it on an H100: bytes — each pass reads the tables once (8 B
// an element for f32i32 and f32f32, 4 B for f32, 6 B for f32i16: at [2^18,
// 128] 80.1 / 40.1 / 60.1 us at 3.35 TB/s) and the output is noise; the
// sums are a few operations per element.  The design streams with coalesced
// vector loads: a CTA of 1024 threads sums one tile at a time, thread (row
// lane rl, column group cg) reading the 4 columns 4cg .. 4cg + 3 (a float4
// / int4, or a short4 of an i16 row) of rows rl, rl + 32, ..., so a warp
// reads one table row (512 B, or 256 B of i16); four rows in flight per
// thread.  The 32 row-lane partial sums of each column meet in shared
// memory.  The CTA shape is the same at every tile size: at 64-row tiles
// half its row lanes have no row in the unrolled step (correct, not
// tuned).
//
// Each pass must stream the tables from device memory.  The grid is
// persistent: min(tiles, CTAs resident at once) CTAs, CTA b summing tiles
// b, b + grid, ... in every pass, so between two reads of a tile the
// whole table (128-512 MiB in the probes; L2 holds 50 MB) streams.  One
// CTA per tile looping over its own tile replays L2 instead: at 256-row
// tiles the resident CTAs' tiles (33 MB) stay in L2, and a pass took
// 0.0316 ms on an H100, 2.6 times less than its bytes need from memory.
// At the bench's shape (64 tiles) the grid is still one CTA per tile.
// No pointer is __restrict__, for every mix: the output store of one pass
// could alias the tables as far as the compiler knows (and the barriers
// between tiles order memory), so each pass reloads them.
//
// f32i16 keeps every i16 load live.  Only row 0 of a tile enters its value,
// and a load whose value is never used is dropped by the compiler, so the
// kernel would read a row of c per tile instead of the table the reference
// reads whole (its block DMA counts 6 B an element).  Each thread sums
// every c element it loads as int and tests the sum against INT_MIN, a
// value it cannot reach (|sum| <= 4 * 32768 * tile_rows / 32 < 2^31 for
// tiles of fewer than 2^19 rows, which the wrapper holds to): the test is
// never true, so the value is unchanged, but the compiler cannot prove
// that, so every load stays.

#include <algorithm>
#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 128;
constexpr int kGroups = kCols / 4;          // 4-column groups per row
constexpr int kRowLanes = 32;
constexpr int kThreads = kGroups * kRowLanes;  // 1024
constexpr int kUnroll = 4;
constexpr int kOutRows = 8;

enum StreamMix : int { kF32I32 = 0, kF32F32 = 1, kF32 = 2, kF32I16 = 3 };

// per mix: c's 4-column group, and the type (and 4-vector) c is summed in;
// kF32 reads no c (its entries are placeholders)
template <int Mix> struct CTable {
  using G = int4;
  using S = int;
  using S4 = int4;
};
template <> struct CTable<kF32F32> {
  using G = float4;
  using S = float;
  using S4 = float4;
};
template <> struct CTable<kF32I16> {
  using G = short4;
  using S = int;
  using S4 = int4;
};

template <int Mix>
__global__ void __launch_bounds__(kThreads)
stream_kernel(const float* v, const void* c, int ntiles, int tile_rows,
              int reps, float* out) {
  using G = typename CTable<Mix>::G;
  using S = typename CTable<Mix>::S;
  using S4 = typename CTable<Mix>::S4;
  constexpr bool kReadC = Mix != kF32;
  constexpr bool kSumC = Mix == kF32I32 || Mix == kF32F32;  // c enters s
  __shared__ float sv[kRowLanes][kCols];
  __shared__ S sc[kSumC ? kRowLanes : 1][kCols];
  __shared__ float s_out[kCols];
  const int cg = threadIdx.x % kGroups;
  const int rl = threadIdx.x / kGroups;
  const float4* v4 = reinterpret_cast<const float4*>(v);
  const G* c4 = reinterpret_cast<const G*>(c);

  // every pass walks this CTA's tiles (the grid is persistent)
  for (int rep = 0; rep < reps; ++rep)
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const size_t tile0 = static_cast<size_t>(tile) * tile_rows;
    float4 fs = make_float4(0.f, 0.f, 0.f, 0.f);
    S4 is = {};
    for (int r = rl; r < tile_rows; r += kRowLanes * kUnroll) {
      float4 fv[kUnroll];
      G iv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int rr = r + u * kRowLanes;
        if (rr < tile_rows) {
          const size_t at = (tile0 + rr) * kGroups + cg;
          fv[u] = v4[at];
          if constexpr (kReadC) iv[u] = c4[at];
        } else {
          fv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if constexpr (kReadC) iv[u] = G{};
        }
      }
      if constexpr (Mix == kF32I16) {
        if (r == 0) {  // the tile's row 0 (row lane 0, first step)
          fs.x += iv[0].x > 0 ? fv[0].x : 0.f;
          fs.y += iv[0].y > 0 ? fv[0].y : 0.f;
          fs.z += iv[0].z > 0 ? fv[0].z : 0.f;
          fs.w += iv[0].w > 0 ? fv[0].w : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        fs.x += fv[u].x; fs.y += fv[u].y; fs.z += fv[u].z; fs.w += fv[u].w;
        if constexpr (kReadC) {
          is.x += iv[u].x; is.y += iv[u].y; is.z += iv[u].z; is.w += iv[u].w;
        }
      }
    }
    if constexpr (Mix == kF32I16) {
      // never true (see the header): keeps every i16 load live
      if (is.x + is.y + is.z + is.w == INT_MIN) fs.x += 1.f;
    }
    sv[rl][4 * cg + 0] = fs.x; sv[rl][4 * cg + 1] = fs.y;
    sv[rl][4 * cg + 2] = fs.z; sv[rl][4 * cg + 3] = fs.w;
    if constexpr (kSumC) {
      sc[rl][4 * cg + 0] = is.x; sc[rl][4 * cg + 1] = is.y;
      sc[rl][4 * cg + 2] = is.z; sc[rl][4 * cg + 3] = is.w;
    }
    __syncthreads();
    if (threadIdx.x < kCols) {
      float f = 0.f;
      S n = S(0);
      for (int q = 0; q < kRowLanes; ++q) {
        f += sv[q][threadIdx.x];
        if constexpr (kSumC) n += sc[q][threadIdx.x];
      }
      s_out[threadIdx.x] = kSumC ? f + static_cast<float>(n) : f;
    }
    __syncthreads();
    // 8 output rows x 128 columns: one value per thread
    const int orow = threadIdx.x / kCols;
    const int ocol = threadIdx.x % kCols;
    out[(static_cast<size_t>(tile) * kOutRows + orow) * kCols + ocol] =
        s_out[ocol];
    __syncthreads();  // sv/sc/s_out are rewritten by the next tile
  }
}

static_assert(kOutRows * kCols == kThreads, "one output value per thread");

// CTAs of this instance resident at once on the card: queried once, on the
// first launch's device (0 if the query failed)
template <int Mix>
int resident_ctas() {
  static const int n = [] {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, stream_kernel<Mix>, kThreads, 0) != cudaSuccess) {
      return 0;
    }
    return sms * per_sm;
  }();
  return n;
}

// the grid is min(ntiles, resident CTAs); written to *ctas when not null
template <int Mix>
int launch_stream(const float* v, const void* c, int ntiles, int tile_rows,
                  int reps, float* out, int* ctas, void* stream) {
  if (ntiles > 0 && reps > 0) {
    const int grid = std::min(ntiles, resident_ctas<Mix>());
    if (grid < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (ctas != nullptr) *ctas = grid;
    stream_kernel<Mix><<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        v, c, ntiles, tile_rows, reps, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// the one entry, for every mix; mix is a StreamMix (c may be null for kF32).  The launch's
// grid is written to *ctas (not null).  Returns cudaErrorInvalidValue for
// an unknown mix.
extern "C" int mmp_stream_probe(const float* v, const void* c, int mix,
                                int ntiles, int tile_rows, int reps,
                                float* out, int* ctas, void* stream) {
  switch (mix) {
    case kF32I32:
      return launch_stream<kF32I32>(v, c, ntiles, tile_rows, reps, out, ctas,
                                    stream);
    case kF32F32:
      return launch_stream<kF32F32>(v, c, ntiles, tile_rows, reps, out, ctas,
                                    stream);
    case kF32:
      return launch_stream<kF32>(v, c, ntiles, tile_rows, reps, out, ctas,
                                 stream);
    case kF32I16:
      return launch_stream<kF32I16>(v, c, ntiles, tile_rows, reps, out, ctas,
                                    stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
