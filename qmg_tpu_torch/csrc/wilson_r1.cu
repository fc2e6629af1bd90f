// Rank-1 Wilson Dslash (w = 1) on U(1) x spin-2, one thread per site.
//
// Replaces qmg_tpu/pallas_wilson.py::_wilson_rank1_kernel. Computes
//
//   out(s) = alpha x(s) + sum_d (U_d(s)/2) comb_d(x(s + d)),  alpha = 2 + m,
//
// where each Wilson projector at w = 1 is rank 1, so direction d costs one
// complex multiply on a pre-combined neighbour spinor:
//
//   a_xp = v1 - v0        a_xm = -(v0 + v1)
//   a_yp = -(v0 + i v1)   a_ym = -(v0 - i v1)        t_d = phase_d * a_d
//   out0 = alpha x0 + t_xp + t_xm + t_yp + t_ym
//   out1 = alpha x1 - t_xp + t_xm - i t_yp + i t_ym
//
// Layouts (complex64, the package's standard layout):
//   x, out : (2 parity, Y, Xh, 2 spin)  -> one float4 per site
//   phase  : (4 dir, 2 parity, Y, Xh)   -> one float2 per site and
//            direction, = U_d/2 including the conj of the backward links
// Neighbours follow the pull semantics of cshift_pull: the destination
// (q, y, xh) reads parity 1-q; +-y move the row with wrap; +x reads column
// xh on rows with y%2 == q and xh+1 otherwise, -x reads xh-1 on rows with
// y%2 == q and xh otherwise (all mod Xh).
//
// What bounds it on an H100: bytes. Per site it reads 32 B of phases and
// 16 B of its own spinor, writes 16 B, and reads four neighbour spinors
// that neighbouring threads also read (cache hits) - 64 B/site of
// compulsory traffic for 52 flops of arithmetic. At 512^2 one
// apply's 16.8 MB sits in the 50 MB L2, so launch latency dominates; at
// 2048^2 it streams from HBM. This first version is one simple coalesced
// thread-per-site kernel: consecutive threads take consecutive xh, so
// every load and the store are 8- or 16-byte vector accesses that
// coalesce. Shared-memory row tiling, TMA and CUDA graphs are left for
// later work.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__global__ void __launch_bounds__(256)
wilson_r1_kernel(const float2* __restrict__ phase,
                 const float4* __restrict__ x,
                 float4* __restrict__ out, int y_len, int xh_len,
                 float alpha) {
  const int half = y_len * xh_len;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * half) return;
  const int q = idx / half;
  const int rem = idx - q * half;
  const int y = rem / xh_len;
  const int xh = rem - y * xh_len;

  const float4* src = x + (1 - q) * half;     // neighbours: other parity
  const int yp = (y + 1 == y_len) ? 0 : y + 1;
  const int ym = (y == 0) ? y_len - 1 : y - 1;
  const bool direct = (y & 1) == q;
  const int xp = direct ? xh : (xh + 1 == xh_len ? 0 : xh + 1);
  const int xm = direct ? (xh == 0 ? xh_len - 1 : xh - 1) : xh;

  const float4 vxp = src[y * xh_len + xp];
  const float4 vxm = src[y * xh_len + xm];
  const float4 vyp = src[yp * xh_len + xh];
  const float4 vym = src[ym * xh_len + xh];
  const float4 s = x[idx];

  // phase[(d * 2 + q) * half + rem], d in {+x, +y, -x, -y}
  const float2 p_xp = phase[(0 * 2 + q) * half + rem];
  const float2 p_yp = phase[(1 * 2 + q) * half + rem];
  const float2 p_xm = phase[(2 * 2 + q) * half + rem];
  const float2 p_ym = phase[(3 * 2 + q) * half + rem];

  // float4 = (v0.re, v0.im, v1.re, v1.im)
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
  out[idx] = o;
}

}  // namespace

// Launches on ``stream`` and returns cudaGetLastError() (0 on success).
extern "C" int wilson_r1_launch(const void* phase, const void* x, void* out,
                                int y_len, int xh_len, float alpha,
                                void* stream) {
  const int n = 2 * y_len * xh_len;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  wilson_r1_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(phase), static_cast<const float4*>(x),
      static_cast<float4*>(out), y_len, xh_len, alpha);
  return static_cast<int>(cudaGetLastError());
}
