// Generic distance-1 stencil apply for any nc in {1, 2, 4, 8, 16}.
//
//   out(s) = sum_{t=0..4} C_t(s) v_t(s),
//   v = [x(s), x(s + x), x(s + y), x(s - x), x(s - y)],
//   C = [clover + mass pattern, H_+x, H_+y, H_-x, H_-y]   (nc x nc each)
//
// Three entries, each with its own C launcher:
//
//   dslash_launch        replaces qmg_tpu/pallas_dslash.py::_dslash_kernel
//                        (K4), the interleaved layout;
//   dslash_split_launch  replaces ::_dslash_split_kernel (K5), the same
//                        arithmetic on rows stored by y % 2;
//   dslash_small_launch  replaces ::_dslash_small_kernel (K6), the split
//                        layout with x staged in shared memory.
//
// Layouts (complex64 fields, channels built by dslash_kernel.py):
//   interleaved  x, out (2p, Y, Xh, nc);       C (5, 2p, Y, Xh, nc, nc)
//   split        x, out (2p, 2r, Yh, Xh, nc);  C (5, 2p, 2r, Yh, Xh, nc, nc)
// Within a parity both are "storage row, xh, colour": the split layout is
// the interleaved one with row y stored at r * Yh + m (y = 2m + r), so K4
// and K5 are one kernel template that differs only in the neighbour row
// map. Coefficients are float2 (complex64) or __nv_bfloat162 (bf16 real,
// bf16 imaginary), widened with __bfloat162float; sums are in float32.
//
// Neighbours follow cshift_pull: destination (q, y, xh) reads parity 1-q;
// +-y move one row with torus wrap (split: half r = 0 reads half 1 at rows
// m and m-1, half r = 1 reads half 0 at rows m+1 and m); the +x source
// column is xh on rows of parity q (y % 2 == q, split: r == q) and xh+1
// otherwise, the -x source column xh-1 on those rows and xh otherwise, all
// mod Xh. Yh = 1 and Xh = 1 need no special case: the wrap is the identity.
//
// What bounds them on an H100: bytes. Per site they read 5 nc^2
// coefficients (8 B each, 4 B in bf16) and the site's own x, and write
// nc outputs: (5 nc^2 + 2 nc) * 8 B = 192 B at nc = 2 and 2688 B at nc = 8
// for 40 nc^2 flops, about 1 flop/byte - far under the card's 20 flops/byte
// of float32 against 3.35 TB/s. The four neighbour vectors are re-reads
// that the L1/L2 caches serve. The design keeps the coefficient stream
// coalesced: for nc >= 4 one thread computes one output row (site, i), so
// the nc threads of a site read consecutive rows of each nc x nc block and
// a warp reads contiguous bytes; for nc <= 2 one thread computes a whole
// site. K6 additionally stages the x rows a block reads (its rows +- 1 and
// its columns +- 1, with wrap) in shared memory, sized from the lattice,
// so every neighbour read is from shared memory. Tiled loads, TMA and
// wider vector loads are left for later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
// Output rows per K6 block, two per thread. The K-cycle's levels get few
// blocks from it: 16 at 32^2 nc8 (tile 1 x 16) and a single one at 8^2
// nc8, far fewer than the card's 132 SMs, so a launch there is latency-
// bound, not bytes-bound. A finer tile rule is left for later work.
constexpr int kSmallOutputsPerBlock = 512;
constexpr int kSmallMaxTileW = 32;

__device__ __forceinline__ float2 widen(float2 c) { return c; }

__device__ __forceinline__ float2 widen(__nv_bfloat162 c) {
  return make_float2(__bfloat162float(c.x), __bfloat162float(c.y));
}

// acc[r] += sum_j C[i0 + r, j] v[j] for one stencil term; ``row0`` points
// at C[i0, 0] of this site and term.
template <int NC, int R, typename CT>
__device__ __forceinline__ void accumulate(const CT* __restrict__ row0,
                                           const float2* v,
                                           float2 (&acc)[R]) {
  float2 vv[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) vv[j] = v[j];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float2 c = widen(row0[r * NC + j]);
      acc[r].x += c.x * vv[j].x - c.y * vv[j].y;
      acc[r].y += c.x * vv[j].y + c.y * vv[j].x;
    }
  }
}

// Rows per thread: a whole site for nc <= 2, one output row otherwise.
template <int NC>
struct RowsPerThread {
  static constexpr int value = NC <= 2 ? NC : 1;
};

// K4 (SPLIT = false) and K5 (SPLIT = true). ``half`` = sites per parity.
template <int NC, typename CT, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
dslash_kernel(const CT* __restrict__ ch, const float2* __restrict__ x,
              float2* __restrict__ out, int y_len, int xh_len) {
  constexpr int R = RowsPerThread<NC>::value;
  constexpr int G = NC / R;  // threads per site
  const int half = y_len * xh_len;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= 2 * half * G) return;
  const int site = tid / G;  // q * half + rem
  const int i0 = (tid - site * G) * R;
  const int q = site / half;
  const int rem = site - q * half;
  const int row = rem / xh_len;  // storage row
  const int xh = rem - row * xh_len;

  int par, row_yp, row_ym;
  if (SPLIT) {
    const int yh_len = y_len >> 1;
    const int r = row >= yh_len ? 1 : 0;
    const int m = row - r * yh_len;
    par = r;
    if (r == 0) {
      row_yp = yh_len + m;
      row_ym = yh_len + (m == 0 ? yh_len - 1 : m - 1);
    } else {
      row_yp = m + 1 == yh_len ? 0 : m + 1;
      row_ym = m;
    }
  } else {
    par = row & 1;
    row_yp = row + 1 == y_len ? 0 : row + 1;
    row_ym = row == 0 ? y_len - 1 : row - 1;
  }
  const bool direct = par == q;
  const int xp = direct ? xh : (xh + 1 == xh_len ? 0 : xh + 1);
  const int xm = direct ? (xh == 0 ? xh_len - 1 : xh - 1) : xh;

  const float2* src = x + (1 - q) * half * NC;
  const float2* nb[5] = {x + site * NC,
                         src + (row * xh_len + xp) * NC,
                         src + (row_yp * xh_len + xh) * NC,
                         src + (row * xh_len + xm) * NC,
                         src + (row_ym * xh_len + xh) * NC};
  float2 acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = make_float2(0.f, 0.f);
#pragma unroll
  for (int t = 0; t < 5; ++t) {
    accumulate<NC, R, CT>(ch + ((t * 2 + q) * half + rem) * NC * NC + i0 * NC,
                          nb[t], acc);
  }
  float2* o = out + site * NC + i0;
#pragma unroll
  for (int r = 0; r < R; ++r) o[r] = acc[r];
}

// K6. Block b owns a tile of tile_t rows x tile_w columns of the Yh x Xh
// plane in all four (q, r) halves. It stages x at rows m0-1 .. m0+tile_t
// and columns x0-1 .. x0+tile_w of all four (p, r) halves (torus wrap) in
// shared memory, laid out [h = 2p + r][row][column][colour], then
// computes its outputs from there.
template <int NC, typename CT>
__global__ void __launch_bounds__(kThreads)
dslash_small_kernel(const CT* __restrict__ ch, const float2* __restrict__ x,
                    float2* __restrict__ out, int yh_len, int xh_len,
                    int tile_t, int tile_w) {
  extern __shared__ float2 sx[];
  constexpr int R = RowsPerThread<NC>::value;
  constexpr int G = NC / R;
  const int tt2 = tile_t + 2;
  const int tw2 = tile_w + 2;
  const int n_tx = (xh_len + tile_w - 1) / tile_w;
  const int m0 = (blockIdx.x / n_tx) * tile_t;
  const int x0 = (blockIdx.x % n_tx) * tile_w;
  const int half = 2 * yh_len * xh_len;  // sites per parity

  const int n_stage = 4 * tt2 * tw2 * NC;
  for (int k = threadIdx.x; k < n_stage; k += blockDim.x) {
    const int c = k % NC;
    int rest = k / NC;
    const int lc = rest % tw2;
    rest /= tw2;
    const int lr = rest % tt2;
    const int h = rest / tt2;
    const int gm = ((m0 - 1 + lr) % yh_len + yh_len) % yh_len;
    const int gx = ((x0 - 1 + lc) % xh_len + xh_len) % xh_len;
    sx[k] = x[((h * yh_len + gm) * xh_len + gx) * NC + c];
  }
  __syncthreads();

  const int n_out = 4 * tile_t * tile_w * G;
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
    const int g = o % G;
    int rest = o / G;
    const int lw = rest % tile_w;
    rest /= tile_w;
    const int lt = rest % tile_t;
    const int h = rest / tile_t;  // 2q + r of the destination
    const int m = m0 + lt;
    const int xx = x0 + lw;
    if (m >= yh_len || xx >= xh_len) continue;
    const int q = h >> 1;
    const int r = h & 1;
    const int ps = 2 * (1 - q);  // first source half (p, r = 0)
    const int lr = lt + 1;
    const int lc = lw + 1;
    const bool direct = r == q;
#define QMG_SX(hh, rr, cc) (sx + (((hh) * tt2 + (rr)) * tw2 + (cc)) * NC)
    const float2* nb[5] = {
        QMG_SX(h, lr, lc),
        QMG_SX(ps + r, lr, direct ? lc : lc + 1),
        r == 0 ? QMG_SX(ps + 1, lr, lc) : QMG_SX(ps, lr + 1, lc),
        QMG_SX(ps + r, lr, direct ? lc - 1 : lc),
        r == 0 ? QMG_SX(ps + 1, lr - 1, lc) : QMG_SX(ps, lr, lc)};
#undef QMG_SX
    const int rem = (r * yh_len + m) * xh_len + xx;
    const int i0 = g * R;
    float2 acc[R];
#pragma unroll
    for (int rr = 0; rr < R; ++rr) acc[rr] = make_float2(0.f, 0.f);
#pragma unroll
    for (int t = 0; t < 5; ++t) {
      accumulate<NC, R, CT>(
          ch + ((t * 2 + q) * half + rem) * NC * NC + i0 * NC, nb[t], acc);
    }
    float2* dst = out + (q * half + rem) * NC + i0;
#pragma unroll
    for (int rr = 0; rr < R; ++rr) dst[rr] = acc[rr];
  }
}

template <int NC, typename CT, bool SPLIT>
int launch_dslash(const void* ch, const void* x, void* out, int y_len,
                  int xh_len, cudaStream_t stream) {
  constexpr int G = NC / RowsPerThread<NC>::value;
  const int n = 2 * y_len * xh_len * G;
  const int blocks = (n + kThreads - 1) / kThreads;
  dslash_kernel<NC, CT, SPLIT><<<blocks, kThreads, 0, stream>>>(
      static_cast<const CT*>(ch), static_cast<const float2*>(x),
      static_cast<float2*>(out), y_len, xh_len);
  return static_cast<int>(cudaGetLastError());
}

template <int NC, typename CT>
int launch_small(const void* ch, const void* x, void* out, int yh_len,
                 int xh_len, cudaStream_t stream) {
  constexpr int G = NC / RowsPerThread<NC>::value;
  const int tile_w = xh_len < kSmallMaxTileW ? xh_len : kSmallMaxTileW;
  int tile_t = kSmallOutputsPerBlock / (4 * tile_w * G);
  tile_t = tile_t < 1 ? 1 : (tile_t > yh_len ? yh_len : tile_t);
  const int blocks = ((yh_len + tile_t - 1) / tile_t) *
                     ((xh_len + tile_w - 1) / tile_w);
  const size_t smem =
      sizeof(float2) * 4 * (tile_t + 2) * (tile_w + 2) * NC;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dslash_small_kernel<NC, CT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dslash_small_kernel<NC, CT><<<blocks, kThreads, smem, stream>>>(
      static_cast<const CT*>(ch), static_cast<const float2*>(x),
      static_cast<float2*>(out), yh_len, xh_len, tile_t, tile_w);
  return static_cast<int>(cudaGetLastError());
}

template <typename CT, bool SPLIT>
int dispatch_dslash(int nc, const void* ch, const void* x, void* out,
                    int y_len, int xh_len, cudaStream_t s) {
  switch (nc) {
    case 1: return launch_dslash<1, CT, SPLIT>(ch, x, out, y_len, xh_len, s);
    case 2: return launch_dslash<2, CT, SPLIT>(ch, x, out, y_len, xh_len, s);
    case 4: return launch_dslash<4, CT, SPLIT>(ch, x, out, y_len, xh_len, s);
    case 8: return launch_dslash<8, CT, SPLIT>(ch, x, out, y_len, xh_len, s);
    case 16: return launch_dslash<16, CT, SPLIT>(ch, x, out, y_len, xh_len, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename CT>
int dispatch_small(int nc, const void* ch, const void* x, void* out,
                   int yh_len, int xh_len, cudaStream_t s) {
  switch (nc) {
    case 1: return launch_small<1, CT>(ch, x, out, yh_len, xh_len, s);
    case 2: return launch_small<2, CT>(ch, x, out, yh_len, xh_len, s);
    case 4: return launch_small<4, CT>(ch, x, out, yh_len, xh_len, s);
    case 8: return launch_small<8, CT>(ch, x, out, yh_len, xh_len, s);
    case 16: return launch_small<16, CT>(ch, x, out, yh_len, xh_len, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Each launcher launches on ``stream`` and returns cudaGetLastError() (0 on
// success; cudaErrorInvalidValue for an nc outside {1, 2, 4, 8, 16}).
// ``coeff_bf16`` selects bf16 coefficient pairs over complex64.

// K4: x, out (2, Y, Xh, nc); ch (5, 2, Y, Xh, nc, nc).
extern "C" int dslash_launch(const void* ch, int coeff_bf16, const void* x,
                             void* out, int nc, int y_len, int xh_len,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return coeff_bf16
             ? dispatch_dslash<__nv_bfloat162, false>(nc, ch, x, out, y_len,
                                                      xh_len, s)
             : dispatch_dslash<float2, false>(nc, ch, x, out, y_len, xh_len,
                                              s);
}

// K5: x, out (2, 2, Yh, Xh, nc); ch (5, 2, 2, Yh, Xh, nc, nc).
extern "C" int dslash_split_launch(const void* ch, int coeff_bf16,
                                   const void* x, void* out, int nc,
                                   int yh_len, int xh_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return coeff_bf16
             ? dispatch_dslash<__nv_bfloat162, true>(nc, ch, x, out,
                                                     2 * yh_len, xh_len, s)
             : dispatch_dslash<float2, true>(nc, ch, x, out, 2 * yh_len,
                                             xh_len, s);
}

// K6: the layouts of K5.
extern "C" int dslash_small_launch(const void* ch, int coeff_bf16,
                                   const void* x, void* out, int nc,
                                   int yh_len, int xh_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return coeff_bf16
             ? dispatch_small<__nv_bfloat162>(nc, ch, x, out, yh_len, xh_len,
                                              s)
             : dispatch_small<float2>(nc, ch, x, out, yh_len, xh_len, s);
}
