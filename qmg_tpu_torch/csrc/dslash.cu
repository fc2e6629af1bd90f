// Generic distance-1 stencil apply for any nc in {1, 2, 4, 8, 16}.
//
//   out(s) = sum_{t=0..4} C_t(s) v_t(s),
//   v = [x(s), x(s + x), x(s + y), x(s - x), x(s - y)],
//   C = [clover + mass pattern, H_+x, H_+y, H_-x, H_-y]   (nc x nc each)
//
// Five entries, each with its own C launcher:
//
//   dslash_launch        replaces qmg_tpu/pallas_dslash.py::_dslash_kernel
//                        (K4), the interleaved layout;
//   dslash_split_launch  replaces ::_dslash_split_kernel (K5), the same
//                        arithmetic on rows stored by y % 2;
//   dslash_small_launch, dslash_small_interleaved_launch
//                        replace ::_dslash_small_kernel (K6), the kernel
//                        of the lattices too small to stream, in the
//                        split layout (the TPU kernel's) and in the
//                        interleaved one (the solve's own);
//   dslash_small_rhs_launch
//                        K6 in the interleaved layout on nrhs fields at
//                        once (the batched solve's coarse levels), one
//                        block row of the grid a field.
//
// Layouts (complex64 fields, channels built by dslash_kernel.py):
//   interleaved  x, out (2p, Y, Xh, nc);       C (5, 2p, Y, Xh, nc, nc)
//   split        x, out (2p, 2r, Yh, Xh, nc);  C (5, 2p, 2r, Yh, Xh, nc, nc)
// Within a parity both are "storage row, xh, colour": the split layout is
// the interleaved one with row y stored at r * Yh + m (y = 2m + r), so
// every kernel here is a template that differs between the layouts only
// in the neighbour row map (``stencil_sources``). Coefficients are float2
// (complex64) or __nv_bfloat162 (bf16 real, bf16 imaginary), widened with
// __bfloat162float; sums are in float32.
//
// Neighbours follow cshift_pull: destination (q, y, xh) reads parity 1-q;
// +-y move one row with torus wrap (split: half r = 0 reads half 1 at rows
// m and m-1, half r = 1 reads half 0 at rows m+1 and m); the +x source
// column is xh on rows of parity q (y % 2 == q, split: r == q) and xh+1
// otherwise, the -x source column xh-1 on those rows and xh otherwise, all
// mod Xh. Yh = 1 and Xh = 1 need no special case: the wrap is the identity.
//
// K4 and K5 (replace qmg_tpu/pallas_dslash.py::_dslash_kernel and
// ::_dslash_split_kernel, whose grids stream row tiles of x with halo rows
// and the channels through VMEM). What bounds them on an H100: bytes. Per
// site they read 5 nc^2 coefficients (8 B each, 4 B in bf16) and the
// site's own x, and write nc outputs: (5 nc^2 + 2 nc) * 8 B = 192 B at
// nc = 2 and 10496 B at nc = 16 for 40 nc^2 flops, about 1 flop/byte -
// far under the card's 20 flops/byte of float32 against 3.35 TB/s, so
// tensor cores (wgmma) would buy nothing. The channels are 71-98% of the
// bytes; the four neighbour vectors are re-reads that L1/L2 serve.
//
// The design, chosen by timing four in one run on an H100 (device alone,
// us, old -> new; PERF.md; qmg_tpu_torch/stencil_bench.py), each
// (nc, coefficient type) taking its body at compile time:
//   * K6's lane split (dslash_lanes_kernel) at nc = 2, 4 and 16, and at
//     nc = 8 with bf16 coefficients: a lane takes 16 bytes of one row of
//     each term's coefficients and of x, neighbouring lanes neighbouring
//     bytes, so each load instruction of a warp reads 512 contiguous bytes
//     of channels; the row's lanes join by shuffles. The template before
//     it gave a thread a whole output row, nc loads of 8 bytes, each warp
//     instruction touching 32 lines 8 nc bytes apart and coming back to
//     them nc - 1 times: at nc = 16 the lines left L1 between visits
//     (33-36 registers, no spills: not register pressure). K4 nc16 128^2
//     (the domain-wall operator at Ls 8) 112.0 -> 59.1, 87% of the bound;
//     nc16 256^2 359.4 -> 228.8; nc4 1024^2 255.5 -> 254.6; nc2 2048^2
//     291.3 -> 285.6; nc8 bf16 512^2 130.9 -> 129.9, 128^2 8.3 -> 5.7.
//   * a thread an output row (dslash_rows_kernel, the template's body
//     before the redesign) at nc = 1 and at nc = 8 with complex64
//     coefficients, where the lane split lost at some shape: nc1 512^2
//     3.63 against 3.70 (2048^2 87.5 against 87.6; at nc = 1 the lane
//     split is the same mapping with K6's bookkeeping), nc8 128^2 (44 MB,
//     inside the 50 MB L2: the Ls 4 domain-wall operator) 14.5 against
//     15.1, K5 14.4 against 15.8. At the streaming nc8 512^2 the lane
//     split wins (237.0 against 246.5, K5 242.6 against 258.4), but one
//     body an instantiation, no switch on the shape. There K5 keeps
//     storage order: walked in row order the body gets 32 registers
//     (8 blocks an SM instead of 6) and its strided loads ran slower
//     (278 against 258).
//   * the grid is K6's (small_grid): blocks of 256 threads, halved down
//     to one warp until there are as many blocks as SMs.
//   * K5 walks its sites in lattice row order (YWALK, as K3 walks y;
//     all but the old body at nc = 8, above): in storage order its +-y rows, a quarter of the lattice away, are
//     read again from HBM. nc2 2048^2 317.3 -> 286.2 (307.7 in storage
//     order), nc1 100.3 -> 89.5: K5 now runs at K4's speed.
//   * not kept: tiles of consecutive sites of one parity whose five channel
//     runs (and, as a fourth variant, the tile's x rows) a producer warp
//     copies into a ring of shared-memory stages by TMA bulk copies
//     (cp.async.bulk, one mbarrier a stage), consumers computing from
//     shared memory (csrc/dslash_tma.cu of commit 1782ea6). Both lost at
//     every nc and coefficient type under every plan tried: nc16 128^2
//     63.3-75.3, nc2 2048^2 290.8-308.9, nc1 512^2 5.0-6.5. A block's
//     consumers wait on each stage together, and only 2-3 blocks fit an
//     SM beside their stages, while the lane split keeps 48-64 warps of
//     independent 16-byte loads in flight.
// Sums are float32; bf16 pairs are widened as they load.
//
// K6. The TPU kernel keeps a whole small lattice in VMEM and applies it in
// one grid step, because such a level is bound there by the latency of a
// chain of small operations, not by bandwidth. Here too nothing streams:
// a 32^2 nc8 level is 2.75 MB, of which the 2.6 MB of coefficients stay in
// the 50 MB L2 from one apply to the next and x (64 KB) in L1/L2. What
// bounds the kernel is the latency of one launch that fills only a part
// of the card, and inside it each thread's chain of dependent loads. The
// design shortens the chain and widens the launch:
//   * the 5 nc products of one output row are split over L lanes (L = 4
//     at nc = 8 with complex64 coefficients); a lane makes one 16-byte
//     coefficient load (two complex64, or four bf16 pairs) and one or two
//     16-byte loads of x per stencil term, all ten independent of each
//     other, and the L partial sums are joined with __shfl_xor_sync.
//     Neighbouring lanes read neighbouring 16 bytes, the lanes of a site
//     one contiguous nc x nc block per term; the threads of a site that
//     read the same x chunk are served by one broadcast load;
//   * the block size falls from 256 threads to as few as 32 until the
//     grid has at least as many blocks as the card has SMs
//     (cudaDevAttrMultiProcessorCount): 256 blocks of 128 threads at 32^2
//     nc8 and 64 blocks of 32 threads at 8^2 nc8, where a tile rule that
//     gave each block 512 output rows launched 16 blocks and 1;
//   * x is not staged in shared memory. A staged variant (each site's
//     five neighbour vectors copied to shared memory once by the site's
//     own warp, indexed by (site in block, term, lane), then a warp
//     barrier) was timed beside this one in one run on an H100, on the
//     device alone at nc = 8: it came out 0.1-0.2 us faster at 8^2 and
//     32^2 and 0.1-0.2 us slower at 64^2, of 2-3 us a launch and under a
//     host path of 14-30 us a call. That pays for no second code path
//     (staging fits only the nc whose site is one warp): the re-reads it
//     saves are L1 broadcasts. PERF.md has the numbers;
//   * the row map is a template parameter, so the solve applies its
//     coarse levels in the interleaved layout its fields already have,
//     without the two layout copies that the split entry needs;
//   * with an rhs axis (the batched solve) block row b of the grid
//     applies field b: the first field's block rows bring a level's
//     coefficients (2.6 MB at 32^2 nc8) into L2 and the others read them
//     there, all fields side by side. Reading them once instead, in
//     threads that keep them in registers and loop over the fields,
//     chains nrhs rounds of loads in each thread: on an H100 at nrhs 8
//     that is slower on the device alone at 32^2 and 8^2 nc8 (PERF.md
//     has the numbers);
// nc = 1 keeps 8-byte (4-byte in bf16) loads, nc = 2 in bf16 8-byte ones.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float2 widen(float2 c) { return c; }

__device__ __forceinline__ float2 widen(__nv_bfloat162 c) {
  return make_float2(__bfloat162float(c.x), __bfloat162float(c.y));
}

// The five sources of destination (q, row, xh), as site offsets into x:
// the site itself, then its +x, +y, -x, -y neighbours in the other parity.
// ``row`` is a storage row; ``half`` = sites per parity.
template <bool SPLIT>
__device__ __forceinline__ void stencil_sources(int q, int row, int xh,
                                                int y_len, int xh_len,
                                                int (&src)[5]) {
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
  const int half = y_len * xh_len;
  const int other = (1 - q) * half;
  src[0] = q * half + row * xh_len + xh;
  src[1] = other + row * xh_len + xp;
  src[2] = other + row_yp * xh_len + xh;
  src[3] = other + row * xh_len + xm;
  src[4] = other + row_ym * xh_len + xh;
}

// K6's split of one output row over lanes: a lane takes V consecutive
// coefficients of the row per stencil term, in one load of at most 16
// bytes, and L = NC / V lanes share the row.
constexpr int small_lanes(int nc, int coeff_bytes) {
  return nc * coeff_bytes <= 16 ? 1 : nc * coeff_bytes / 16;
}

template <int NC, typename CT>
struct SmallShape {
  static constexpr int L = small_lanes(NC, sizeof(CT));
  static constexpr int V = NC / L;
};

template <int BYTES> struct Word;
template <> struct Word<4> { using type = unsigned int; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<16> { using type = uint4; };

// V coefficients at ``p`` (aligned to V * sizeof(CT)) in one load.
template <typename CT, int V>
__device__ __forceinline__ void load_coeffs(const CT* __restrict__ p,
                                            float2 (&c)[V]) {
  using W = typename Word<sizeof(CT) * V>::type;
  const W w = __ldg(reinterpret_cast<const W*>(p));
  const CT* e = reinterpret_cast<const CT*>(&w);
#pragma unroll
  for (int k = 0; k < V; ++k) c[k] = widen(e[k]);
}

// V complex64 at ``p`` (aligned to min(16, 8 V) bytes) in 16-byte loads.
template <int V>
__device__ __forceinline__ void load_x(const float2* __restrict__ p,
                                       float2 (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = __ldg(p);
  } else {
#pragma unroll
    for (int k = 0; k < V; k += 2) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(p + k));
      v[k] = make_float2(w.x, w.y);
      v[k + 1] = make_float2(w.z, w.w);
    }
  }
}

// One output row from its lanes: each lane sums its V columns of the five
// terms, and the row's L lanes (neighbours in the warp) join their sums by
// shuffles, so that every lane holds the row. Every lane of the warp must
// call it.
template <int L, int V>
__device__ __forceinline__ float2 row_sum(const float2 (&c)[5][V],
                                          const float2 (&v)[5][V]) {
  float2 acc = make_float2(0.f, 0.f);
#pragma unroll
  for (int t = 0; t < 5; ++t) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      acc.x += c[t][k].x * v[t][k].x - c[t][k].y * v[t][k].y;
      acc.y += c[t][k].x * v[t][k].y + c[t][k].y * v[t][k].x;
    }
  }
#pragma unroll
  for (int m = L >> 1; m > 0; m >>= 1) {
    acc.x += __shfl_xor_sync(0xffffffffu, acc.x, m);
    acc.y += __shfl_xor_sync(0xffffffffu, acc.y, m);
  }
  return acc;
}

// Storage row of lattice row y: the split layout stores y = 2m + r at
// r * Yh + m.
template <bool SPLIT>
__device__ __forceinline__ int storage_row(int y, int y_len) {
  return SPLIT ? (y & 1) * (y_len >> 1) + (y >> 1) : y;
}

// K6, and K4 / K5 at nc >= 2 (on a streaming grid, one block row). Thread
// tid is lane tid % L of output row tid / L = (site, i); it
// sums its V columns of the five terms, the row's lanes join their sums by
// shuffles and lane 0 writes. No thread leaves before the shuffles: one
// past the last row works on row 0 and does not write.
//
// The rhs axis: x and out hold gridDim.y fields one after another, and
// block row b = blockIdx.y applies field b with the same loads and the
// same sums in the same order as every other, so field b of the output is
// bit for bit the single-field kernel on field b. One field is a grid of
// one block row. The sites are walked in storage order, or with YWALK in
// lattice row order (K5: the split layout's +-y rows lie in the other
// half, a quarter of the lattice away, and walked in storage order they
// leave L2 before the rows next to them need them).
template <int NC, typename CT, bool SPLIT, bool YWALK = false>
__global__ void __launch_bounds__(kThreads)
dslash_lanes_kernel(const CT* __restrict__ ch, const float2* __restrict__ x,
                    float2* __restrict__ out, int y_len, int xh_len) {
  constexpr int V = SmallShape<NC, CT>::V;
  constexpr int L = SmallShape<NC, CT>::L;
  const int half = y_len * xh_len;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = tid < 2 * half * NC * L;
  const int orow = live ? tid / L : 0;  // site * NC + i
  const int j0 = (tid % L) * V;
  const int site = orow / NC;
  const int i = orow - site * NC;
  const int q = site / half;
  const int walked = site - q * half;
  const int y = walked / xh_len;
  const int xh = walked - y * xh_len;
  const int row = YWALK ? storage_row<SPLIT>(y, y_len) : y;
  const int rem = row * xh_len + xh;
  int src[5];
  stencil_sources<SPLIT>(q, row, xh, y_len, xh_len, src);

  const size_t field = static_cast<size_t>(blockIdx.y) * 2 * half * NC;
  x += field;
  out += field;

  float2 c[5][V], v[5][V];
#pragma unroll
  for (int t = 0; t < 5; ++t) {
    load_coeffs<CT, V>(
        ch + (((t * 2 + q) * half + rem) * NC + i) * NC + j0, c[t]);
    load_x<V>(x + src[t] * NC + j0, v[t]);
  }
  const float2 acc = row_sum<L, V>(c, v);
  if (live && j0 == 0) out[(q * half + rem) * NC + i] = acc;
}

// acc[r] += sum_j C[i0 + r, j] v[j] for one stencil term, as the template
// before the redesign summed it (x first); ``row0`` points at C[i0, 0] of
// this site and term.
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

// K4 and K5 where the lane split did not beat the body of the template
// before it (see the header): that body as it was written, one thread an
// output row (site, i0), its nc coefficients of each term and the term's
// nc neighbour values by 8-byte (bf16 coefficients: 4-byte) loads; sites
// in storage order, or with YWALK in lattice row order. Keep its text: at
// nc = 8 nvcc gives it 34 registers (6 blocks an SM), and a version with
// the one row folded in got 32 (8 blocks) and ran 10% slower at 512^2.
template <int NC, typename CT, bool SPLIT, bool YWALK>
__global__ void __launch_bounds__(kThreads)
dslash_rows_kernel(const CT* __restrict__ ch, const float2* __restrict__ x,
                   float2* __restrict__ out, int y_len, int xh_len) {
  constexpr int R = 1;       // rows a thread
  constexpr int G = NC / R;  // threads per site
  const int half = y_len * xh_len;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= 2 * half * G) return;
  const int site = tid / G;  // q * half + the walked rem
  const int i0 = (tid - site * G) * R;
  const int q = site / half;
  int rem = site - q * half;
  int row = rem / xh_len;
  const int xh = rem - row * xh_len;
  if (YWALK) {
    row = storage_row<SPLIT>(row, y_len);
    rem = row * xh_len + xh;
  }
  int src[5];
  stencil_sources<SPLIT>(q, row, xh, y_len, xh_len, src);

  float2 acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = make_float2(0.f, 0.f);
#pragma unroll
  for (int t = 0; t < 5; ++t) {
    accumulate<NC, R, CT>(ch + ((t * 2 + q) * half + rem) * NC * NC + i0 * NC,
                          x + src[t] * NC, acc);
  }
  float2* o = out + (q * half + rem) * NC + i0;
#pragma unroll
  for (int r = 0; r < R; ++r) o[r] = acc[r];
}

// K4 / K5's body at (nc, coefficient bytes): a thread an output row at
// nc = 1 and at nc = 8 with complex64 coefficients, K6's lanes otherwise.
constexpr bool rows_body(int nc, int coeff_bytes) {
  return nc == 1 || (nc == 8 && coeff_bytes == 8);
}

__global__ void empty_kernel() {}

// SMs of the current device, asked once per device.
int sm_count(int* sms) {
  static int known[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  if (known[device] == 0) {
    err = cudaDeviceGetAttribute(&known[device],
                                 cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  *sms = known[device];
  return 0;
}

// K6's grid for ``threads_total`` threads of one field and ``nrhs`` block
// rows: blocks of 256 threads, halved down to one warp until the grid has
// at least as many blocks as SMs; ``blocks`` is its width.
int small_grid(int threads_total, int nrhs, int* blocks, int* threads) {
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  int t = kThreads;
  while (t > 32 && nrhs * ((threads_total + t - 1) / t) < sms) {
    t >>= 1;
  }
  *threads = t;
  *blocks = (threads_total + t - 1) / t;
  return 0;
}

template <int NC, typename CT, bool SPLIT>
int launch_small(const void* ch, const void* x, void* out, int y_len,
                 int xh_len, int nrhs, cudaStream_t stream) {
  if (nrhs < 1 || nrhs > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int blocks = 0, threads = 0;
  const int err = small_grid(2 * y_len * xh_len * NC * SmallShape<NC, CT>::L,
                             nrhs, &blocks, &threads);
  if (err != 0) return err;
  dslash_lanes_kernel<NC, CT, SPLIT>
      <<<dim3(blocks, nrhs), threads, 0, stream>>>(
          static_cast<const CT*>(ch), static_cast<const float2*>(x),
          static_cast<float2*>(out), y_len, xh_len);
  return static_cast<int>(cudaGetLastError());
}

// K4 / K5 on K6's grid rule. K5 walks its sites in lattice row order,
// but for the old body at nc = 8 (see the header).
template <int NC, typename CT, bool SPLIT>
int launch_dslash(const void* ch, const void* x, void* out, int y_len,
                  int xh_len, cudaStream_t stream) {
  constexpr bool kRows = rows_body(NC, sizeof(CT));
  int blocks = 0, threads = 0;
  const int err = small_grid(
      2 * y_len * xh_len * NC * (kRows ? 1 : SmallShape<NC, CT>::L), 1,
      &blocks, &threads);
  if (err != 0) return err;
  if constexpr (kRows) {
    dslash_rows_kernel<NC, CT, SPLIT, SPLIT && NC == 1>
        <<<blocks, threads, 0, stream>>>(
            static_cast<const CT*>(ch), static_cast<const float2*>(x),
            static_cast<float2*>(out), y_len, xh_len);
  } else {
    dslash_lanes_kernel<NC, CT, SPLIT, SPLIT>
        <<<blocks, threads, 0, stream>>>(
            static_cast<const CT*>(ch), static_cast<const float2*>(x),
            static_cast<float2*>(out), y_len, xh_len);
  }
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

template <bool SPLIT>
int dslash_entry(const void* ch, int coeff_bf16, const void* x, void* out,
                 int nc, int y_len, int xh_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return coeff_bf16
             ? dispatch_dslash<__nv_bfloat162, SPLIT>(nc, ch, x, out, y_len,
                                                      xh_len, s)
             : dispatch_dslash<float2, SPLIT>(nc, ch, x, out, y_len, xh_len,
                                              s);
}

template <typename CT, bool SPLIT>
int dispatch_small(int nc, const void* ch, const void* x, void* out,
                   int y_len, int xh_len, int nrhs, cudaStream_t s) {
  switch (nc) {
    case 1: return launch_small<1, CT, SPLIT>(ch, x, out, y_len, xh_len,
                                              nrhs, s);
    case 2: return launch_small<2, CT, SPLIT>(ch, x, out, y_len, xh_len,
                                              nrhs, s);
    case 4: return launch_small<4, CT, SPLIT>(ch, x, out, y_len, xh_len,
                                              nrhs, s);
    case 8: return launch_small<8, CT, SPLIT>(ch, x, out, y_len, xh_len,
                                              nrhs, s);
    case 16: return launch_small<16, CT, SPLIT>(ch, x, out, y_len, xh_len,
                                                nrhs, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool SPLIT>
int small_entry(const void* ch, int coeff_bf16, const void* x, void* out,
                int nc, int y_len, int xh_len, int nrhs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return coeff_bf16
             ? dispatch_small<__nv_bfloat162, SPLIT>(nc, ch, x, out, y_len,
                                                     xh_len, nrhs, s)
             : dispatch_small<float2, SPLIT>(nc, ch, x, out, y_len, xh_len,
                                             nrhs, s);
}

}  // namespace

// Each launcher launches on ``stream`` and returns cudaGetLastError() (0 on
// success; cudaErrorInvalidValue for an nc outside {1, 2, 4, 8, 16}).
// ``coeff_bf16`` selects bf16 coefficient pairs over complex64.

// K4: x, out (2, Y, Xh, nc); ch (5, 2, Y, Xh, nc, nc); aligned as
// dslash_alignment says.
extern "C" int dslash_launch(const void* ch, int coeff_bf16, const void* x,
                             void* out, int nc, int y_len, int xh_len,
                             void* stream) {
  return dslash_entry<false>(ch, coeff_bf16, x, out, nc, y_len, xh_len,
                             stream);
}

// K5: x, out (2, 2, Yh, Xh, nc); ch (5, 2, 2, Yh, Xh, nc, nc); as K4.
extern "C" int dslash_split_launch(const void* ch, int coeff_bf16,
                                   const void* x, void* out, int nc,
                                   int yh_len, int xh_len, void* stream) {
  return dslash_entry<true>(ch, coeff_bf16, x, out, nc, 2 * yh_len, xh_len,
                            stream);
}

// The alignment in bytes that K4 and K5 need of x and out and of the
// channels at nc: 16 where they take K6's lanes, one element where a
// thread takes an output row.
extern "C" int dslash_alignment(int coeff_bf16, int nc, int* x_align,
                                int* ch_align) {
  if (nc != 1 && nc != 2 && nc != 4 && nc != 8 && nc != 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int coeff_bytes =
      coeff_bf16 ? sizeof(__nv_bfloat162) : sizeof(float2);
  const bool rows = rows_body(nc, coeff_bytes);
  *x_align = rows ? sizeof(float2) : 16;
  *ch_align = rows ? coeff_bytes : 16;
  return 0;
}

// K6 in the layouts of K5; ch, x and out 16-byte aligned.
extern "C" int dslash_small_launch(const void* ch, int coeff_bf16,
                                   const void* x, void* out, int nc,
                                   int yh_len, int xh_len, void* stream) {
  return small_entry<true>(ch, coeff_bf16, x, out, nc, 2 * yh_len, xh_len,
                           1, stream);
}

// K6 in the layouts of K4; ch, x and out 16-byte aligned.
extern "C" int dslash_small_interleaved_launch(const void* ch,
                                               int coeff_bf16, const void* x,
                                               void* out, int nc, int y_len,
                                               int xh_len, void* stream) {
  return small_entry<false>(ch, coeff_bf16, x, out, nc, y_len, xh_len, 1,
                            stream);
}

// K6 in the layouts of K4 with an rhs axis: x, out (nrhs, 2, Y, Xh, nc)
// with 1 <= nrhs <= 65535; ch (5, 2, Y, Xh, nc, nc), one set for all
// fields, read by every field's block row (from L2 after the first).
// 16-byte aligned.
extern "C" int dslash_small_rhs_launch(const void* ch, int coeff_bf16,
                                       const void* x, void* out, int nc,
                                       int y_len, int xh_len, int nrhs,
                                       void* stream) {
  return small_entry<false>(ch, coeff_bf16, x, out, nc, y_len, xh_len, nrhs,
                            stream);
}

// The grid K6 launches on the current device for a lattice of
// ``sites`` = 2 Y Xh sites and ``nrhs`` fields (block rows): its width in
// blocks, their threads and the card's SMs.
extern "C" int dslash_small_grid(int coeff_bf16, int nc, int sites, int nrhs,
                                 int* blocks, int* threads, int* sms) {
  if (nc != 1 && nc != 2 && nc != 4 && nc != 8 && nc != 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int lanes = small_lanes(
      nc, coeff_bf16 ? sizeof(__nv_bfloat162) : sizeof(float2));
  const int err = sm_count(sms);
  return err != 0 ? err
                  : small_grid(sites * nc * lanes, nrhs, blocks, threads);
}

// A kernel that does nothing, on ``stream``: the card's launch floor, for
// measurements.
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
