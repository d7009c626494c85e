// B2: fused projection + BC1 payload + run collapse for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_project_kernel`
// (pcrhpg24_tpu/render/pallas_project.py:83, launched by
// `project_batches` at :218/:243).
//
// What it computes, per decoded entry (batch b, point i, chain c):
// batch-relative projection `(coords - anchor) * scale` through rows
// 0/1/3 of the world-view-projection plus the batch's folded
// translation, the clip tests, the swizzled 32x32-tile pixel id, the
// depth key (the f32 bits of w) and the BC1 colour payload.  In colour
// mode it then collapses runs along each chain (6 doubling steps) and
// across the 1024 chain heads (10 steps); non-heads become the
// sentinel id.  HQS mode writes the stream raw.
//
// Numerics: the op order of pallas_project.py:109-122 is kept with
// explicitly rounded intrinsics (and the library is built with
// -fmad=false): ((t0*x + t1*y) + t2*z) + tb, then inv = 1/w as an IEEE
// division, ndc = c*inv, px = trunc((ndc*0.5 + 0.5)*width).  The depth
// bits decide the image, so nothing here may contract or reassociate.
//
// Bound on the H100: device-memory bytes (12 B of coords + the colour
// words in, 12 B of stream out per entry), then the local-memory
// traffic of the per-chain ladder.  Design: one 1024-thread block per
// batch, one thread per chain; a thread keeps its chain's `points`
// entries in local memory (L1-resident) so the within-chain ladder is a
// plain loop, and the chain-head ladder runs over shared memory with a
// barrier per step.  Reads and writes of a point row are coalesced over
// the 1024 chains.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroups = 8;
constexpr int kLanes = 128;
constexpr int kChains = kGroups * kLanes;  // 1024 threads per block
constexpr int kMaxPoints = 64;

__device__ __forceinline__ void expand565(uint32_t c, uint32_t& r,
                                          uint32_t& g, uint32_t& b) {
  const uint32_t r5 = (c >> 11) & 31u;
  const uint32_t g6 = (c >> 5) & 63u;
  const uint32_t b5 = c & 31u;
  r = (r5 << 3) | (r5 >> 2);
  g = (g6 << 2) | (g6 >> 4);
  b = (b5 << 3) | (b5 >> 2);
}

__device__ __forceinline__ uint32_t chan(uint32_t sel, uint32_t a,
                                         uint32_t b) {
  return sel == 0 ? a
       : sel == 1 ? b
       : sel == 2 ? (a * 2u + b) / 3u
                  : (a + b * 2u) / 3u;
}

// BC1 payload R | G<<8 | B<<16 of point i (pallas_project.py:43-80)
__device__ __forceinline__ uint32_t bc1_payload(uint32_t w0, uint32_t w1,
                                                int i) {
  uint32_t r0, g0, b0, r1, g1, b1;
  expand565(w0 & 0xFFFFu, r0, g0, b0);
  expand565(w0 >> 16, r1, g1, b1);
  const uint32_t sel = (w1 >> (2u * (static_cast<uint32_t>(i) & 15u))) & 3u;
  return chan(sel, r0, r1) | (chan(sel, g0, g1) << 8) |
         (chan(sel, b0, b1) << 16);
}

// u64 (d << 32 | p) order: is (ds, ps) strictly below (d, p)?
__device__ __forceinline__ bool key_less(uint32_t ds, uint32_t ps,
                                         uint32_t d, uint32_t p) {
  return ds < d || (ds == d && ps < p);
}

__global__ void __launch_bounds__(kChains)
project_kernel(const float* __restrict__ frame,    // (12,)
               const int* __restrict__ anchors,    // (C,3)
               const float* __restrict__ tbc,      // (C,4)
               const int* __restrict__ lodn,       // (C,)
               const int* __restrict__ coords,     // (C,points,3,8,128)
               const uint32_t* __restrict__ colors_k,  // (C,4,2,8,128)
               uint32_t* __restrict__ pid_out,     // (C,points,8,128)
               uint32_t* __restrict__ dep_out,
               uint32_t* __restrict__ pay_out,
               int points, int width, int height, int steps,
               int chain_collapse, int collapse) {
  __shared__ uint32_t sp[kChains], sd[kChains], sy[kChains];
  const int b = blockIdx.x;
  const int c = threadIdx.x;  // chain = g*128 + lane
  const int wt = (width + 31) / 32;
  const int ht = (height + 31) / 32;
  const uint32_t sent = static_cast<uint32_t>(wt * ht * 1024);

  const float t00 = frame[0], t01 = frame[1], t02 = frame[2];
  const float t10 = frame[3], t11 = frame[4], t12 = frame[5];
  const float t30 = frame[6], t31 = frame[7], t32 = frame[8];
  const float sx = frame[9], sy_ = frame[10], sz = frame[11];
  const uint32_t ax = static_cast<uint32_t>(anchors[b * 3 + 0]);
  const uint32_t ay = static_cast<uint32_t>(anchors[b * 3 + 1]);
  const uint32_t az = static_cast<uint32_t>(anchors[b * 3 + 2]);
  const float tb0 = tbc[b * 4 + 0], tb1 = tbc[b * 4 + 1], tb3 = tbc[b * 4 + 3];
  const int n = lodn[b];

  const uint32_t* col = colors_k + static_cast<long long>(b) * 8 * kChains + c;
  uint32_t cw0[4], cw1[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    cw0[k] = col[(k * 2 + 0) * kChains];
    cw1[k] = col[(k * 2 + 1) * kChains];
  }

  uint32_t pid[kMaxPoints], dep[kMaxPoints], pay[kMaxPoints];
  const int* crd = coords + static_cast<long long>(b) * points * 3 * kChains + c;
  for (int i = 0; i < points; ++i) {
    const uint32_t xi = static_cast<uint32_t>(crd[(i * 3 + 0) * kChains]);
    const uint32_t yi = static_cast<uint32_t>(crd[(i * 3 + 1) * kChains]);
    const uint32_t zi = static_cast<uint32_t>(crd[(i * 3 + 2) * kChains]);
    const float xs = __fmul_rn(__int2float_rn(static_cast<int>(xi - ax)), sx);
    const float ys = __fmul_rn(__int2float_rn(static_cast<int>(yi - ay)), sy_);
    const float zs = __fmul_rn(__int2float_rn(static_cast<int>(zi - az)), sz);
    const float cx = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(t00, xs),
                                                   __fmul_rn(t01, ys)),
                                         __fmul_rn(t02, zs)), tb0);
    const float cy = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(t10, xs),
                                                   __fmul_rn(t11, ys)),
                                         __fmul_rn(t12, zs)), tb1);
    const float w = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(t30, xs),
                                                  __fmul_rn(t31, ys)),
                                        __fmul_rn(t32, zs)), tb3);
    const float inv = __fdiv_rn(1.0f, w);
    const float ndx = __fmul_rn(cx, inv);
    const float ndy = __fmul_rn(cy, inv);
    bool ok = (i < n) && (w > 0.0f) && (fabsf(ndx) <= 1.0f) &&
              (fabsf(ndy) <= 1.0f);
    // (int) truncates toward zero, as XLA's f32 -> s32 convert does; the
    // value only matters where ok already holds (finite, |ndc| <= 1)
    const int px = static_cast<int>(
        __fmul_rn(__fadd_rn(__fmul_rn(ndx, 0.5f), 0.5f), static_cast<float>(width)));
    const int py = static_cast<int>(
        __fmul_rn(__fadd_rn(__fmul_rn(ndy, 0.5f), 0.5f), static_cast<float>(height)));
    ok = ok && px >= 0 && px < width && py >= 0 && py < height;
    const uint32_t swz = (static_cast<uint32_t>((py >> 5) * wt + (px >> 5)) << 10) |
                         (static_cast<uint32_t>(py & 31) << 5) |
                         static_cast<uint32_t>(px & 31);
    pid[i] = ok ? swz : sent;
    dep[i] = __float_as_uint(w);
    const int blk = i >> 4;
    pay[i] = bc1_payload(cw0[blk], cw1[blk], i);
  }

  const long long row = static_cast<long long>(b) * points * kChains + c;
  if (!collapse) {
    for (int i = 0; i < points; ++i) {
      pid_out[row + i * kChains] = pid[i];
      dep_out[row + i * kChains] = dep[i];
      pay_out[row + i * kChains] = pay[i];
    }
    return;
  }

  // within-chain ladder (pallas_project.py:141-157): at step s entry i
  // takes entry i+s's current key where the two pids are equal; past the
  // end the neighbour is (sent, 0, 0).  Ascending in place, entry i+s is
  // still the previous step's value when i reads it.
  const int lim = points < (1 << steps) ? points : (1 << steps);
  for (int s = 1; s < lim; s *= 2) {
    for (int i = 0; i < points; ++i) {
      const bool in = i < points - s;
      const uint32_t ps = in ? pid[i + s] : sent;
      const uint32_t ds = in ? dep[i + s] : 0u;
      const uint32_t ys = in ? pay[i + s] : 0u;
      if (ps == pid[i] && key_less(ds, ys, dep[i], pay[i])) {
        dep[i] = ds;
        pay[i] = ys;
      }
    }
  }
  const int first = chain_collapse ? 1 : 0;
  for (int i = first; i < points; ++i) {
    const uint32_t prev = i == 0 ? sent : pid[i - 1];
    pid_out[row + i * kChains] = pid[i] != prev ? pid[i] : sent;
    dep_out[row + i * kChains] = dep[i];
    pay_out[row + i * kChains] = pay[i];
  }
  if (!chain_collapse) return;

  // chain-head ladder over the i = 0 slice (pallas_project.py:166-210):
  // chain c takes chain c+k's key where the pids are equal, k = 1..512
  sp[c] = pid[0];
  sd[c] = dep[0];
  sy[c] = pay[0];
  __syncthreads();
  for (int k = 1; k < kChains; k *= 2) {
    const bool in = c < kChains - k;
    const uint32_t ps = in ? sp[c + k] : sent;
    const uint32_t ds = in ? sd[c + k] : 0u;
    const uint32_t ys = in ? sy[c + k] : 0u;
    const bool take = ps == sp[c] && key_less(ds, ys, sd[c], sy[c]);
    __syncthreads();
    if (take) {
      sd[c] = ds;
      sy[c] = ys;
    }
    __syncthreads();
  }
  const uint32_t prevc = c == 0 ? sent : sp[c - 1];
  pid_out[row] = sp[c] != prevc ? sp[c] : sent;
  dep_out[row] = sd[c];
  pay_out[row] = sy[c];
}

}  // namespace

extern "C" int pcr_project(const void* frame, const void* anchors,
                           const void* tbc, const void* lodn,
                           const void* coords, const void* colors_k,
                           void* pid, void* dep, void* pay, int batches,
                           int points, int width, int height, int steps,
                           int chain_collapse, int collapse, void* stream) {
  project_kernel<<<batches, kChains, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frame), static_cast<const int*>(anchors),
      static_cast<const float*>(tbc), static_cast<const int*>(lodn),
      static_cast<const int*>(coords), static_cast<const uint32_t*>(colors_k),
      static_cast<uint32_t*>(pid), static_cast<uint32_t*>(dep),
      static_cast<uint32_t*>(pay), points, width, height, steps,
      chain_collapse, collapse);
  return static_cast<int>(cudaGetLastError());
}
