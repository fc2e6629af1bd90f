// The Wilson Dslash kernels on U(1) x spin-2, one thread per site.
//
//   wilson_r1_kernel<false>  rank-1 apply at w = 1, interleaved layout, on
//                            one field or on nrhs fields with one set of
//                            phases (the batched solve's level 0);
//                            replaces qmg_tpu/pallas_wilson.py::
//                            _wilson_rank1_kernel
//   wilson_r1_kernel<true>   the same arithmetic in the row-parity-split
//                            layout; replaces ::_wilson_split_kernel
//   wilson_phase_kernel      apply at any Wilson coefficient w, interleaved
//                            layout; replaces ::_wilson_kernel
//   wilson_r1_halo_kernel    the rank-1 apply on a y-slab of a lattice cut
//                            into slabs, on one field or on nrhs fields with
//                            one set of phases: the row below the slab and
//                            the row above it come in as halo rows, nothing
//                            wraps in y; replaces ::_wilson_rank1_kernel in
//                            its halo_frame form, which
//                            qmg_tpu/shard_dslash.py::
//                            make_sharded_pallas_wilson runs on each shard
//
// All four compute, from per-direction phases p_d = U_d/2 (the conj of the
// backward links included),
//
//   out(s) = alpha x(s) + sum_d p_d(s) P_d x(s + d),   alpha = 2w + m,
//   P_+x = [[-w, 1], [1, -w]]    P_+y = [[-w, -i], [ i, -w]]
//   P_-x = [[-w,-1], [-1,-w]]    P_-y = [[-w,  i], [-i, -w]].
//
// At w = 1 every P_d is rank 1, so the rank-1 kernels spend one complex
// multiply per direction on a pre-combined neighbour spinor:
//
//   a_xp = v1 - v0        a_xm = -(v0 + v1)
//   a_yp = -(v0 + i v1)   a_ym = -(v0 - i v1)        t_d = p_d * a_d
//   out0 = alpha x0 + t_xp + t_xm + t_yp + t_ym
//   out1 = alpha x1 - t_xp + t_xm - i t_yp + i t_ym
//
// The any-w kernel multiplies both spins, t_s = p_d v_s, then adds the
// diagonal -w t_s and the off-diagonal couplings of P_d. w and alpha are
// run-time arguments: one build serves every operator.
//
// Layouts (complex64):
//   interleaved  x, out (2 parity, Y, Xh, 2 spin)  -> one float4 per site
//                phase  (4 dir, 2 parity, Y, Xh)   -> one float2 per site
//                                                      and direction
//   split        the same arrays with row y = 2m + r stored at row
//                r * Yh + m: x (2p, 2r, Yh, Xh, 2), phase (4, 2p, 2r, Yh, Xh)
// Neighbours follow the pull semantics of cshift_pull: the destination
// (q, y, xh) reads parity 1-q; +-y move the row with wrap; +x reads column
// xh on rows with y%2 == q and xh+1 otherwise, -x reads xh-1 on rows with
// y%2 == q and xh otherwise (all mod Xh).
//
// What bounds them on an H100: bytes. Per site each reads 32 B of phases
// and 16 B of its own spinor, writes 16 B, and reads four neighbour
// spinors that neighbouring threads also read (cache hits) - 64 B/site of
// compulsory traffic for 52 flops (rank-1) or about 100 (any w); with nrhs
// fields the phases are read once, 32 + 32 nrhs B/site. At 512^2
// one apply's 16.8 MB sits in the 50 MB L2, so launch latency dominates; at
// 2048^2 it streams from HBM. These are simple coalesced thread-per-site
// kernels: consecutive threads take consecutive xh, so every load and the
// store are 8- or 16-byte vector accesses that coalesce. The split layout
// was a TPU device (it turns row-parity selects into lane rolls); here it
// changes only the row map. Walked in storage order it would read every
// spinor a third time from HBM (the +-y neighbours of one row-parity half
// are the other half, a quarter of the lattice away), so its threads walk
// the rows in y order instead. Shared-memory row tiling, TMA and CUDA graphs
// are left for later work.
//
// The slab kernel. The TPU kernel reads a frame of the slab with 8 halo
// rows on each side, 8 being its DMA granule; the stencil reaches one row,
// so here a halo is one row per side: top = row y0 - 1 and bot = row
// y0 + Y_loc of the whole field, both parities, (2, Xh, 2 spin). They are
// pointers of their own (the receive buffers of a halo exchange, or rows
// of a neighbouring slab in place), so no frame is assembled: that copy
// would read and write the whole slab, 32 B/site on top of the 64. Row
// y = 0 takes its -y neighbour from top, row Y_loc - 1 its +y neighbour
// from bot; +-x wrap inside the slab. Y_loc is even, so a slab row's
// parity is its parity in the whole lattice. x, phase, out and the halos
// each come with the distance between their two parity halves (in
// sites), so a slab may be a view of rows y0 .. y0 + Y_loc of a whole
// field as well as a block of its own; the phases' direction stride is
// twice their parity stride in both cases. One slab moves 64 B/site plus
// 2 halo rows x 2 parities x Xh x 16 B.
//
// The slab kernel on nrhs fields (the batched solve's level 0 on a mesh)
// is K1 rhs's loop on K7's body: x, out and the halos each hold nrhs
// fields at a field stride of their own (in sites), the thread reads its
// four phases once and applies them to each field in turn, with K7's
// loads and arithmetic, so field b of the output is bit for bit the slab
// kernel on field b alone (nrhs = 1). A launch moves 32 + 32 nrhs B/site
// plus nrhs x 2 halo rows.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// One thread's site: its index, and the indices of its four neighbours
// within the other parity's half of x.
struct Site {
  int q, rem, idx;
  int xp, yp, xm, ym;
};

// Storage row of lattice row y: y itself, or (y % 2) * Yh + y / 2 in the
// split layout.
template <bool SPLIT>
__device__ __forceinline__ int storage_row(int y, int y_len) {
  return SPLIT ? (y & 1) * (y_len >> 1) + (y >> 1) : y;
}

// Threads walk the lattice rows in y order in both layouts, so that a row
// read as a +-y neighbour is still in cache when the next rows need it.
template <bool SPLIT>
__device__ __forceinline__ bool locate(int y_len, int xh_len, Site& s) {
  const int half = y_len * xh_len;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= 2 * half) return false;
  s.q = tid / half;
  const int y = (tid - s.q * half) / xh_len;
  const int xh = tid - s.q * half - y * xh_len;
  const int row = storage_row<SPLIT>(y, y_len);
  const int row_yp = storage_row<SPLIT>(y + 1 == y_len ? 0 : y + 1, y_len);
  const int row_ym = storage_row<SPLIT>(y == 0 ? y_len - 1 : y - 1, y_len);
  s.rem = row * xh_len + xh;
  s.idx = s.q * half + s.rem;
  const bool direct = (y & 1) == s.q;
  const int col_xp = direct ? xh : (xh + 1 == xh_len ? 0 : xh + 1);
  const int col_xm = direct ? (xh == 0 ? xh_len - 1 : xh - 1) : xh;
  s.xp = row * xh_len + col_xp;
  s.xm = row * xh_len + col_xm;
  s.yp = row_yp * xh_len + xh;
  s.ym = row_ym * xh_len + xh;
  return true;
}

// The rank-1 kernels' arithmetic on one site: the four pulled neighbour
// spinors, the site's own spinor s and its four phases.
// float4 = (v0.re, v0.im, v1.re, v1.im).
__device__ __forceinline__ float4 rank1_site(
    const float4 vxp, const float4 vxm, const float4 vyp, const float4 vym,
    const float4 s, const float2 p_xp, const float2 p_yp, const float2 p_xm,
    const float2 p_ym, const float alpha) {
  const float2 a_xp = make_float2(vxp.z - vxp.x, vxp.w - vxp.y);
  const float2 a_xm = make_float2(-(vxm.x + vxm.z), -(vxm.y + vxm.w));
  const float2 a_yp = make_float2(-(vyp.x - vyp.w), -(vyp.y + vyp.z));
  const float2 a_ym = make_float2(-(vym.x + vym.w), -(vym.y - vym.z));

  const float2 t_xp = cmul(p_xp, a_xp);
  const float2 t_xm = cmul(p_xm, a_xm);
  const float2 t_yp = cmul(p_yp, a_yp);
  const float2 t_ym = cmul(p_ym, a_ym);

  float4 o;
  o.x = alpha * s.x + (t_xp.x + t_xm.x) + (t_yp.x + t_ym.x);
  o.y = alpha * s.y + (t_xp.y + t_xm.y) + (t_yp.y + t_ym.y);
  o.z = alpha * s.z + (t_xm.x - t_xp.x) + (t_yp.y - t_ym.y);
  o.w = alpha * s.w + (t_xm.y - t_xp.y) + (t_ym.x - t_yp.x);
  return o;
}

// ``nrhs`` fields of x and out lie one after another; the thread loads its
// site's four phases once and applies them to each field in turn, with the
// same loads and the same ``rank1_site`` arithmetic, so field b of the
// output is bit for bit the kernel on field b alone (nrhs = 1).
template <bool SPLIT>
__global__ void __launch_bounds__(kThreads)
wilson_r1_kernel(const float2* __restrict__ phase,
                 const float4* __restrict__ x,
                 float4* __restrict__ out, int y_len, int xh_len,
                 float alpha, int nrhs) {
  Site st;
  if (!locate<SPLIT>(y_len, xh_len, st)) return;
  const int half = y_len * xh_len;

  // phase[(d * 2 + q) * half + rem], d in {+x, +y, -x, -y}
  const float2 p_xp = phase[(0 * 2 + st.q) * half + st.rem];
  const float2 p_yp = phase[(1 * 2 + st.q) * half + st.rem];
  const float2 p_xm = phase[(2 * 2 + st.q) * half + st.rem];
  const float2 p_ym = phase[(3 * 2 + st.q) * half + st.rem];

  const size_t field = 2 * static_cast<size_t>(half);
  for (int b = 0; b < nrhs; ++b) {
    const float4* xb = x + b * field;
    const float4* src = xb + (1 - st.q) * half;  // neighbours: other parity
    const float4 vxp = src[st.xp];
    const float4 vxm = src[st.xm];
    const float4 vyp = src[st.yp];
    const float4 vym = src[st.ym];
    const float4 s = xb[st.idx];
    out[b * field + st.idx] = rank1_site(vxp, vxm, vyp, vym, s, p_xp, p_yp,
                                         p_xm, p_ym, alpha);
  }
}

// One thread per site of the slab (2 parity, y_len rows, xh_len), over
// nrhs fields. The strides *_ps are the distances between the two parity
// halves and *_fs those between two fields, in sites.
__global__ void __launch_bounds__(kThreads)
wilson_r1_halo_kernel(const float2* __restrict__ phase,
                      const float4* __restrict__ x,
                      const float4* __restrict__ top,
                      const float4* __restrict__ bot,
                      float4* __restrict__ out, int nrhs, int y_len,
                      int xh_len, int phase_ps, int x_ps, int halo_ps,
                      int out_ps, int x_fs, int halo_fs, int out_fs,
                      float alpha) {
  const int half = y_len * xh_len;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= 2 * half) return;
  const int q = tid / half;
  const int rem = tid - q * half;
  const int y = rem / xh_len;
  const int xh = rem - y * xh_len;
  // y_len is even: the slab row's parity is the lattice row's.
  const bool direct = (y & 1) == q;
  const int col_xp = direct ? xh : (xh + 1 == xh_len ? 0 : xh + 1);
  const int col_xm = direct ? (xh == 0 ? xh_len - 1 : xh - 1) : xh;

  const float2 p_xp = phase[(0 * 2 + q) * phase_ps + rem];
  const float2 p_yp = phase[(1 * 2 + q) * phase_ps + rem];
  const float2 p_xm = phase[(2 * 2 + q) * phase_ps + rem];
  const float2 p_ym = phase[(3 * 2 + q) * phase_ps + rem];

  for (int b = 0; b < nrhs; ++b) {
    const float4* xb = x + b * static_cast<size_t>(x_fs);
    const size_t halo_b = b * static_cast<size_t>(halo_fs);
    const float4* src = xb + (1 - q) * x_ps;     // neighbours: other parity
    const float4* halo_top = top + halo_b + (1 - q) * halo_ps;
    const float4* halo_bot = bot + halo_b + (1 - q) * halo_ps;

    const float4 vxp = src[y * xh_len + col_xp];
    const float4 vxm = src[y * xh_len + col_xm];
    const float4 vyp = y + 1 == y_len ? halo_bot[xh] : src[rem + xh_len];
    const float4 vym = y == 0 ? halo_top[xh] : src[rem - xh_len];
    const float4 s = xb[q * x_ps + rem];

    out[b * static_cast<size_t>(out_fs) + q * out_ps + rem] = rank1_site(
        vxp, vxm, vyp, vym, s, p_xp, p_yp, p_xm, p_ym, alpha);
  }
}

__global__ void __launch_bounds__(kThreads)
wilson_phase_kernel(const float2* __restrict__ phase,
                    const float4* __restrict__ x,
                    float4* __restrict__ out, int y_len, int xh_len,
                    float w, float alpha) {
  Site st;
  if (!locate<false>(y_len, xh_len, st)) return;
  const int half = y_len * xh_len;
  const float4* src = x + (1 - st.q) * half;

  const float4 vxp = src[st.xp];
  const float4 vyp = src[st.yp];
  const float4 vxm = src[st.xm];
  const float4 vym = src[st.ym];
  const float4 s = x[st.idx];
  const float2 p_xp = phase[(0 * 2 + st.q) * half + st.rem];
  const float2 p_yp = phase[(1 * 2 + st.q) * half + st.rem];
  const float2 p_xm = phase[(2 * 2 + st.q) * half + st.rem];
  const float2 p_ym = phase[(3 * 2 + st.q) * half + st.rem];

  // acc = (out0.re, out0.im, out1.re, out1.im); per direction t_s = p v_s,
  // the diagonal -w t_s, then the off-diagonal couplings.
  float4 acc = make_float4(alpha * s.x, alpha * s.y, alpha * s.z,
                           alpha * s.w);
  float2 t0, t1;

  t0 = cmul(p_xp, make_float2(vxp.x, vxp.y));   // +x: [[., +1], [+1, .]]
  t1 = cmul(p_xp, make_float2(vxp.z, vxp.w));
  acc.x += t1.x - w * t0.x;
  acc.y += t1.y - w * t0.y;
  acc.z += t0.x - w * t1.x;
  acc.w += t0.y - w * t1.y;

  t0 = cmul(p_yp, make_float2(vyp.x, vyp.y));   // +y: [[., -i], [+i, .]]
  t1 = cmul(p_yp, make_float2(vyp.z, vyp.w));
  acc.x += t1.y - w * t0.x;
  acc.y -= t1.x + w * t0.y;
  acc.z -= t0.y + w * t1.x;
  acc.w += t0.x - w * t1.y;

  t0 = cmul(p_xm, make_float2(vxm.x, vxm.y));   // -x: [[., -1], [-1, .]]
  t1 = cmul(p_xm, make_float2(vxm.z, vxm.w));
  acc.x -= t1.x + w * t0.x;
  acc.y -= t1.y + w * t0.y;
  acc.z -= t0.x + w * t1.x;
  acc.w -= t0.y + w * t1.y;

  t0 = cmul(p_ym, make_float2(vym.x, vym.y));   // -y: [[., +i], [-i, .]]
  t1 = cmul(p_ym, make_float2(vym.z, vym.w));
  acc.x -= t1.y + w * t0.x;
  acc.y += t1.x - w * t0.y;
  acc.z += t0.y - w * t1.x;
  acc.w -= t0.x + w * t1.y;

  out[st.idx] = acc;
}

inline int blocks_for(int rows, int xh_len) {
  return (2 * rows * xh_len + kThreads - 1) / kThreads;
}

}  // namespace

// Each launches on ``stream`` and returns cudaGetLastError() (0 on success).

// x, out (nrhs, 2, Y, Xh, 2) and phase (4, 2, Y, Xh): the rank-1 apply on
// nrhs fields with one set of phases.
extern "C" int wilson_r1_rhs_launch(const void* phase, const void* x,
                                    void* out, int nrhs, int y_len,
                                    int xh_len, float alpha, void* stream) {
  if (nrhs < 1) return static_cast<int>(cudaErrorInvalidValue);
  wilson_r1_kernel<false><<<blocks_for(y_len, xh_len), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(phase), static_cast<const float4*>(x),
      static_cast<float4*>(out), y_len, xh_len, alpha, nrhs);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wilson_r1_launch(const void* phase, const void* x, void* out,
                                int y_len, int xh_len, float alpha,
                                void* stream) {
  return wilson_r1_rhs_launch(phase, x, out, 1, y_len, xh_len, alpha, stream);
}

// x, out (2, 2, Yh, Xh, 2) and phase (4, 2, 2, Yh, Xh) in the split layout.
extern "C" int wilson_r1_split_launch(const void* phase, const void* x,
                                      void* out, int yh_len, int xh_len,
                                      float alpha, void* stream) {
  wilson_r1_kernel<true><<<blocks_for(2 * yh_len, xh_len), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(phase), static_cast<const float4*>(x),
      static_cast<float4*>(out), 2 * yh_len, xh_len, alpha, 1);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wilson_phase_launch(const void* phase, const void* x,
                                   void* out, int y_len, int xh_len, float w,
                                   float alpha, void* stream) {
  wilson_phase_kernel<<<blocks_for(y_len, xh_len), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(phase), static_cast<const float4*>(x),
      static_cast<float4*>(out), y_len, xh_len, w, alpha);
  return static_cast<int>(cudaGetLastError());
}

// The rank-1 apply on a slab of y_len (even) rows of nrhs fields: x, out
// (nrhs, 2, y_len, Xh, 2) and phase (4, 2, y_len, Xh) with parity strides
// x_ps, out_ps, phase_ps (the phases' direction stride is 2 * phase_ps)
// and field strides x_fs, out_fs; top, bot (nrhs, 2, Xh, 2) with parity
// stride halo_ps and field stride halo_fs; all strides in sites.
extern "C" int wilson_r1_halo_rhs_launch(
    const void* phase, const void* x, const void* top, const void* bot,
    void* out, int nrhs, int y_len, int xh_len, int phase_ps, int x_ps,
    int halo_ps, int out_ps, int x_fs, int halo_fs, int out_fs, float alpha,
    void* stream) {
  if (nrhs < 1) return static_cast<int>(cudaErrorInvalidValue);
  wilson_r1_halo_kernel<<<blocks_for(y_len, xh_len), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(phase), static_cast<const float4*>(x),
      static_cast<const float4*>(top), static_cast<const float4*>(bot),
      static_cast<float4*>(out), nrhs, y_len, xh_len, phase_ps, x_ps,
      halo_ps, out_ps, x_fs, halo_fs, out_fs, alpha);
  return static_cast<int>(cudaGetLastError());
}
