// stream_ceiling: the device-memory stream probe of the kernel bench.
//
// Two [rows, 128] tables, f32 `v` and int32 `c`, cut into tiles of
// `tile_rows` rows.  For tile t and column j:
//     s[t][j] = sum_rows(v[tile t])[j] + float(sum_rows(c[tile t])[j])
// (the int32 sum converted once), written into 8 output rows per tile:
// out is [rows / tile_rows * 8, 128] f32, rows 8t .. 8t + 7 all s[t].  The
// whole computation is repeated `reps` times inside one launch, so a time
// per pass is the delta of two launches with different `reps`, as the
// reference times it.
//
// Replaces the reference package's bench.py:118 stream_ceiling, a Pallas
// grid over (reps, tiles) with 4096-row tiles of two [2^18, 128] tables
// (268,435,456 B together), whose per-tile output block is 8 rows.
//
// What bounds it on an H100: bytes — the tables are read once per pass
// (268 MB at 3.35 TB/s: 80.1 us) and the 262 KB output is noise; the sums
// are a few operations per 8 B.  The design streams with 16-byte coalesced
// loads: one CTA of 1024 threads per tile, thread (row lane rl, column
// group cg) reads float4 / int4 column group cg of rows rl, rl + 32, ...,
// so a warp reads one 512 B table row; four rows in flight per thread.  The
// 32 row-lane partial sums of each column meet in shared memory.  At the
// bench's shape that is 64 CTAs, half the SMs: each SM then needs ~52 GB/s.
// No pointer is __restrict__: the output store of one pass could alias the
// tables as far as the compiler knows, so the next pass reloads them.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 128;
constexpr int kGroups = kCols / 4;          // float4 column groups per row
constexpr int kRowLanes = 32;
constexpr int kThreads = kGroups * kRowLanes;  // 1024
constexpr int kUnroll = 4;
constexpr int kOutRows = 8;

__global__ void __launch_bounds__(kThreads)
stream_ceiling_kernel(const float* v, const int* c, int tile_rows, int reps,
                      float* out) {
  __shared__ float sv[kRowLanes][kCols];
  __shared__ int sc[kRowLanes][kCols];
  __shared__ float s_out[kCols];
  const int cg = threadIdx.x % kGroups;
  const int rl = threadIdx.x / kGroups;
  const size_t tile0 = static_cast<size_t>(blockIdx.x) * tile_rows;
  const float4* v4 = reinterpret_cast<const float4*>(v);
  const int4* c4 = reinterpret_cast<const int4*>(c);

  for (int rep = 0; rep < reps; ++rep) {
    float4 fs = make_float4(0.f, 0.f, 0.f, 0.f);
    int4 is = make_int4(0, 0, 0, 0);
    for (int r = rl; r < tile_rows; r += kRowLanes * kUnroll) {
      float4 fv[kUnroll];
      int4 iv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int rr = r + u * kRowLanes;
        if (rr < tile_rows) {
          const size_t at = (tile0 + rr) * kGroups + cg;
          fv[u] = v4[at];
          iv[u] = c4[at];
        } else {
          fv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          iv[u] = make_int4(0, 0, 0, 0);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        fs.x += fv[u].x; fs.y += fv[u].y; fs.z += fv[u].z; fs.w += fv[u].w;
        is.x += iv[u].x; is.y += iv[u].y; is.z += iv[u].z; is.w += iv[u].w;
      }
    }
    sv[rl][4 * cg + 0] = fs.x; sv[rl][4 * cg + 1] = fs.y;
    sv[rl][4 * cg + 2] = fs.z; sv[rl][4 * cg + 3] = fs.w;
    sc[rl][4 * cg + 0] = is.x; sc[rl][4 * cg + 1] = is.y;
    sc[rl][4 * cg + 2] = is.z; sc[rl][4 * cg + 3] = is.w;
    __syncthreads();
    if (threadIdx.x < kCols) {
      float f = 0.f;
      int n = 0;
      for (int q = 0; q < kRowLanes; ++q) {
        f += sv[q][threadIdx.x];
        n += sc[q][threadIdx.x];
      }
      s_out[threadIdx.x] = f + static_cast<float>(n);
    }
    __syncthreads();
    // 8 output rows x 128 columns: one value per thread
    const int orow = threadIdx.x / kCols;
    const int ocol = threadIdx.x % kCols;
    out[(static_cast<size_t>(blockIdx.x) * kOutRows + orow) * kCols + ocol] =
        s_out[ocol];
    __syncthreads();  // sv/sc/s_out are rewritten by the next pass
  }
}

static_assert(kOutRows * kCols == kThreads, "one output value per thread");

}  // namespace

extern "C" int mmp_stream_ceiling(const float* v, const int* c, int ntiles,
                                  int tile_rows, int reps, float* out,
                                  void* stream) {
  if (ntiles > 0 && reps > 0) {
    stream_ceiling_kernel<<<ntiles, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        v, c, tile_rows, reps, out);
  }
  return static_cast<int>(cudaGetLastError());
}
