// B2: fused projection + colour payload + run collapse for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_project_kernel`
// (pcrhpg24_tpu/render/pallas_project.py:83, launched by
// `project_batches` at :218/:243; ladders :141-157 and :166-210).
//
// What it computes, per decoded entry (batch b, point i, chain c):
// batch-relative projection `(coords - anchor) * scale` through rows
// 0/1/3 of the world-view-projection plus the batch's folded
// translation, the clip tests, the swizzled 32x32-tile pixel id, the
// depth key (the f32 bits of w) and the colour payload.  In colour
// mode it then collapses runs along each chain (doubling steps up to
// min(points, 2**steps)) and across the 1024 chain heads (10 steps);
// non-heads become the sentinel id.  HQS mode writes the stream raw.
// Batch-payload mode (`payload` given, one u32 per batch) writes the
// batch's value as every entry's payload in place of the BC1 colour and
// reads no colour words: the debug frames' batch index or LOD count
// (pcrhpg24_tpu/render/methods/huffman_tpu.py:146-153), in any of the
// three modes.
// The colour format is a template parameter (FMT): BC1 (the flagship's,
// pallas_project.py:43-80), BC7 mode 6 and raw (24-bit colour), whose
// payloads the reference computes in XLA beside its XLA projection
// (bc1_layout.py:68-106, huffman_tpu.py:67-68,155-161).  Each reads its
// own layout (render/bc1_layout.py): a thread holds its chain's 4 BC1
// blocks in 8 registers, its 4 BC7 blocks in 16, and reads a raw colour
// per entry, one coalesced load.  The batch-payload mode reads no colour
// and is one more value of FMT (kPay), so the build has four colour
// instances of each (points, mode) kernel, and the BC1 kernel compiles as
// it did before the other formats came.
// Both ladders are the reference's: at step s entry i takes entry i+s's
// key wherever the two pids are equal, whatever lies between them (so
// `A B A` merges), and past the end the neighbour is (sentinel, 0, 0).
// Every entry reads the previous step's keys, so a step is one
// simultaneous update.
//
// Numerics: the op order of pallas_project.py:109-122 is kept with
// explicitly rounded intrinsics (and the library is built with
// -fmad=false): ((t0*x + t1*y) + t2*z) + tb, then inv = 1/w as an IEEE
// division, ndc = c*inv, px = trunc((ndc*0.5 + 0.5)*width).  The depth
// bits decide the image, so nothing here may contract or reassociate.
//
// Bound on the H100: device-memory bytes (12 B of coords + the colour
// words in, 12 B of stream out per entry).  The first design ran one
// 1024-thread block per batch (64 blocks on 132 SMs, 64 registers a
// thread), each thread walking its chain's entries in local memory,
// which the ladder swept up to six times.  This design:
//  * one 512-thread block per (batch, group), four threads per chain
//    (points slab, slab + 4, ...): 8x the blocks, 32 warps an SM, and
//    coalesced 512-byte rows for every load and store;
//  * colour mode stages the block's points x 128 tile of (pid, dep, pay)
//    in dynamic shared memory, [k][i][chain] with a pitch of 129 words
//    (99 KB at 64 points); HQS mode writes each entry from registers;
//  * the within-chain ladder runs one chain per warp: lane l holds points
//    l and l + 32, reads its column conflict-free, and each step is six
//    `__shfl_sync`s, no barrier and no local memory;
//  * the chain-head ladder runs over the 8 groups of a batch launched as
//    a thread-block cluster of 8: each block keeps its 128 heads in
//    shared memory, reads the others' through distributed shared memory,
//    and double-buffers the keys, so each of the 10 steps needs one
//    cluster barrier.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kGroups = 8;
constexpr int kLanes = 128;
constexpr int kChains = kGroups * kLanes;
constexpr int kMaxPoints = 64;
constexpr int kSlabs = 4;                  // threads per chain
constexpr int kThreads = kSlabs * kLanes;  // 512 per block
constexpr int kPitch = kLanes + 1;         // staged row pitch: conflict-free columns
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kRaw = 0, kCollapse = 1, kChain = 2 };  // HQS, colour, colour + heads
// colour formats (the wrapper's FMT_CODES), and the batch payload
enum Fmt { kBC1 = 0, kBC7 = 1, kRGB = 2, kPay = 3 };

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

// BC7 mode-6 payload of point i of a block's words w0..w3 (bc1_layout.py:
// 68-98; render.cu:122-154): 7-bit endpoints with the p bits p0 (lo's top
// bit) and p1 (hi's bottom bit), the 4-bit index of point i % 16 (the
// anchor read with p1 as its low bit), weight round(idx * 64 / 15).
__device__ __forceinline__ uint32_t bc7_payload(uint32_t w0, uint32_t w1,
                                                uint32_t w2, uint32_t w3, int i) {
  const uint32_t p0 = w1 >> 31, p1 = w2 & 1u;
  const uint32_t r0 = (((w0 >> 7) & 0x7Fu) << 1) | p0;
  const uint32_t r1 = (((w0 >> 14) & 0x7Fu) << 1) | p1;
  const uint32_t g0 = (((w0 >> 21) & 0x7Fu) << 1) | p0;
  const uint32_t g1 = ((((w0 >> 28) | (w1 << 4)) & 0x7Fu) << 1) | p1;
  const uint32_t b0 = (((w1 >> 3) & 0x7Fu) << 1) | p0;
  const uint32_t b1 = (((w1 >> 10) & 0x7Fu) << 1) | p1;
  const uint32_t j = static_cast<uint32_t>(i) & 15u;
  const uint32_t idx = ((j < 8u ? w2 : w3) >> (4u * (j & 7u))) & 0xFu;
  const uint32_t wgt = (idx * 128u + 15u) / 30u;
  const uint32_t iw = 64u - wgt;
  const uint32_t r = (r0 * iw + r1 * wgt + 32u) >> 6;
  const uint32_t g = (g0 * iw + g1 * wgt + 32u) >> 6;
  const uint32_t b = (b0 * iw + b1 * wgt + 32u) >> 6;
  return (r & 0xFFu) | ((g & 0xFFu) << 8) | ((b & 0xFFu) << 16);
}

// w[k] for a k that may be known only at run time, without local memory
__device__ __forceinline__ uint32_t pick4(const uint32_t (&w)[4], int k) {
  return k == 0 ? w[0] : k == 1 ? w[1] : k == 2 ? w[2] : w[3];
}

// u64 (d << 32 | p) order: is (ds, ps) strictly below (d, p)?
__device__ __forceinline__ bool key_less(uint32_t ds, uint32_t ps,
                                         uint32_t d, uint32_t p) {
  return ds < d || (ds == d && ps < p);
}

struct Args {
  const float* frame;        // (12,)
  const int* anchors;        // (C,3)
  const float* tbc;          // (C,4)
  const int* lodn;           // (C,)
  const int* coords;         // (C,points,3,8,128)
  const uint32_t* colors_k;  // BC1 (C,4,2,8,128), BC7 (C,4,4,8,128), raw (C,64,8,128)
  const uint32_t* payload;   // (C,) or null: the colour
  uint32_t* pid;             // (C,points,8,128) each
  uint32_t* dep;
  uint32_t* pay;
  int points, width, height, steps;
};

// One thread's chain: the projection of entry i (pallas_project.py:109-126).
// FMT kPay: every entry's payload is its batch's `payload` word.
template <int FMT>
struct Chain {
  static constexpr bool PAY = FMT == kPay;
  float t00, t01, t02, t10, t11, t12, t30, t31, t32, sx, sy, sz;
  float tb0, tb1, tb3;
  uint32_t ax, ay, az, sent, bpay;
  int n, wt, width, height;
  uint32_t cw0[4], cw1[4];  // the chain's 4 blocks: BC1's 2 words, BC7's first 2
  uint32_t cw2[4], cw3[4];  // BC7's last 2 words
  const uint32_t* craw;     // raw: the chain's colour of point 0
  const int* crd;

  __device__ __forceinline__ Chain(const Args& a, int b, int g, int lane) {
    const float* f = a.frame;
    t00 = f[0]; t01 = f[1]; t02 = f[2];
    t10 = f[3]; t11 = f[4]; t12 = f[5];
    t30 = f[6]; t31 = f[7]; t32 = f[8];
    sx = f[9]; sy = f[10]; sz = f[11];
    ax = static_cast<uint32_t>(a.anchors[b * 3 + 0]);
    ay = static_cast<uint32_t>(a.anchors[b * 3 + 1]);
    az = static_cast<uint32_t>(a.anchors[b * 3 + 2]);
    tb0 = a.tbc[b * 4 + 0]; tb1 = a.tbc[b * 4 + 1]; tb3 = a.tbc[b * 4 + 3];
    n = a.lodn[b];
    width = a.width;
    height = a.height;
    wt = (width + 31) / 32;
    sent = static_cast<uint32_t>(wt * ((height + 31) / 32) * 1024);
    const int c = g * kLanes + lane;
    bpay = PAY ? a.payload[b] : 0u;
    if constexpr (FMT == kBC7) {
      const uint32_t* col = a.colors_k + static_cast<long long>(b) * 16 * kChains + c;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        cw0[k] = col[(k * 4 + 0) * kChains];
        cw1[k] = col[(k * 4 + 1) * kChains];
        cw2[k] = col[(k * 4 + 2) * kChains];
        cw3[k] = col[(k * 4 + 3) * kChains];
      }
    } else if constexpr (FMT == kRGB) {
      craw = a.colors_k + static_cast<long long>(b) * kMaxPoints * kChains + c;
    } else {
      const uint32_t* col = a.colors_k + static_cast<long long>(b) * 8 * kChains + c;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        cw0[k] = PAY ? 0u : col[(k * 2 + 0) * kChains];
        cw1[k] = PAY ? 0u : col[(k * 2 + 1) * kChains];
      }
    }
    crd = a.coords + static_cast<long long>(b) * a.points * 3 * kChains + c;
  }

  // blk = i >> 4, the entry's colour block, passed in so that it can be static
  __device__ __forceinline__ void entry(int i, int blk, uint32_t& pid, uint32_t& dep,
                                        uint32_t& pay) const {
    const uint32_t xi = static_cast<uint32_t>(__ldcs(crd + (i * 3 + 0) * kChains));
    const uint32_t yi = static_cast<uint32_t>(__ldcs(crd + (i * 3 + 1) * kChains));
    const uint32_t zi = static_cast<uint32_t>(__ldcs(crd + (i * 3 + 2) * kChains));
    const float xs = __fmul_rn(__int2float_rn(static_cast<int>(xi - ax)), sx);
    const float ys = __fmul_rn(__int2float_rn(static_cast<int>(yi - ay)), sy);
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
    pid = ok ? swz : sent;
    dep = __float_as_uint(w);
    if constexpr (FMT == kBC7)
      pay = bc7_payload(pick4(cw0, blk), pick4(cw1, blk), pick4(cw2, blk),
                        pick4(cw3, blk), i);
    else if constexpr (FMT == kRGB)
      pay = __ldcs(craw + i * kChains) & 0xFFFFFFu;
    else
      pay = PAY ? bpay : bc1_payload(pick4(cw0, blk), pick4(cw1, blk), i);
  }
};

// Within-chain ladder (pallas_project.py:141-157) of one chain, run by a
// warp: column entry i sits at [i * kPitch]; lane l holds entries l and
// l + 32.  Entries at or past P read as (sent, 0, 0) and never change.
__device__ __forceinline__ void chain_ladder(uint32_t* sp, uint32_t* sd, uint32_t* sy,
                                             int P, int lim, int l, uint32_t sent) {
  const bool has_a = l < P, has_b = l + 32 < P;
  const uint32_t pa = has_a ? sp[l * kPitch] : sent;
  const uint32_t pb = has_b ? sp[(l + 32) * kPitch] : sent;
  uint32_t da = has_a ? sd[l * kPitch] : 0u, ya = has_a ? sy[l * kPitch] : 0u;
  uint32_t db = has_b ? sd[(l + 32) * kPitch] : 0u, yb = has_b ? sy[(l + 32) * kPitch] : 0u;
#pragma unroll
  for (int t = 0; t < 6; ++t) {
    const int s = 1 << t;
    if (s >= lim) break;
    const int src = (l + s) & 31;
    const uint32_t qa = __shfl_sync(kFull, pa, src), qb = __shfl_sync(kFull, pb, src);
    const uint32_t ea = __shfl_sync(kFull, da, src), eb = __shfl_sync(kFull, db, src);
    const uint32_t za = __shfl_sync(kFull, ya, src), zb = __shfl_sync(kFull, yb, src);
    // entry l reads entry l + s; entry l + 32 reads l + 32 + s, past 63 the sentinel
    const bool low = l + s < 32;
    const uint32_t p0 = low ? qa : qb, d0 = low ? ea : eb, y0 = low ? za : zb;
    const uint32_t p1 = low ? qb : sent, d1 = low ? eb : 0u, y1 = low ? zb : 0u;
    if (p0 == pa && key_less(d0, y0, da, ya)) {
      da = d0;
      ya = y0;
    }
    if (p1 == pb && key_less(d1, y1, db, yb)) {
      db = d1;
      yb = y1;
    }
  }
  if (has_a) {
    sd[l * kPitch] = da;
    sy[l * kPitch] = ya;
  }
  if (has_b) {
    sd[(l + 32) * kPitch] = db;
    sy[(l + 32) * kPitch] = yb;
  }
}

// POINTS = 0 takes the count from a.points (any 1..64).
template <int POINTS, int MODE, int FMT>
__global__ void __launch_bounds__(kThreads, 2)
project_kernel(const Args a) {
  extern __shared__ uint32_t stage[];  // [3][P][kPitch]: pid, dep, pay
  __shared__ uint32_t hp[kLanes], hd[2][kLanes], hy[2][kLanes];
  const int P = POINTS ? POINTS : a.points;
  const int b = blockIdx.x / kGroups, g = blockIdx.x % kGroups;  // g: cluster rank
  const int lane = threadIdx.x % kLanes;  // the thread's chain in the group
  const int slab = threadIdx.x / kLanes;  // its points: slab + 4k (block k >> 2)
  const int per = (P + kSlabs - 1) / kSlabs;  // static when POINTS is
  const Chain<FMT> ch(a, b, g, lane);
  const uint32_t sent = ch.sent;
  const long long row = static_cast<long long>(b) * P * kChains + g * kLanes + lane;
  if (MODE == kRaw) {
#pragma unroll 4
    for (int k = 0; k < per; ++k) {
      const int i = slab + k * kSlabs;
      if (i >= P) break;
      uint32_t p, d, y;
      ch.entry(i, k >> 2, p, d, y);
      a.pid[row + i * kChains] = p;
      a.dep[row + i * kChains] = d;
      a.pay[row + i * kChains] = y;
    }
    return;
  }
  uint32_t* sp = stage;
  uint32_t* sd = sp + P * kPitch;
  uint32_t* sy = sd + P * kPitch;
#pragma unroll
  for (int k = 0; k < per; ++k) {
    const int i = slab + k * kSlabs;
    if (i < P)
      ch.entry(i, k >> 2, sp[i * kPitch + lane], sd[i * kPitch + lane],
               sy[i * kPitch + lane]);
  }
  __syncthreads();
  const int lim = a.steps >= 7 ? P : (a.steps <= 0 ? 1 : min(P, 1 << a.steps));
  const int warp = threadIdx.x >> 5;
  for (int c = warp; c < kLanes; c += kThreads / 32)
    chain_ladder(sp + c, sd + c, sy + c, P, lim, threadIdx.x & 31, sent);
  __syncthreads();
#pragma unroll 4
  for (int k = 0; k < per; ++k) {
    const int i = slab + k * kSlabs;
    if (i >= P) break;
    if (MODE == kChain && i == 0) continue;  // the head ladder writes row 0
    const uint32_t cur = sp[i * kPitch + lane];
    const uint32_t prev = i == 0 ? sent : sp[(i - 1) * kPitch + lane];
    a.pid[row + i * kChains] = cur != prev ? cur : sent;
    a.dep[row + i * kChains] = sd[i * kPitch + lane];
    a.pay[row + i * kChains] = sy[i * kPitch + lane];
  }
  if (MODE != kChain) return;

  // chain-head ladder over the i = 0 slice (pallas_project.py:166-210),
  // run by the block's first 128 threads: chain c = g*128 + lane takes
  // chain c+k's key where the pids are equal, k = 1..512; chain c+k's head
  // lives in block (c+k) >> 7 of the cluster.  The pids stay fixed; the
  // keys alternate between two buffers, so a step's reads and the next
  // step's writes never meet.  Every thread of the cluster takes each
  // barrier.
  cg::cluster_group cluster = cg::this_cluster();
  const bool heads = threadIdx.x < kLanes;
  uint32_t pc = 0u, dc = 0u, yc = 0u, prevc = sent;
  if (heads) {
    pc = sp[lane];
    dc = sd[lane];
    yc = sy[lane];
    hp[lane] = pc;
    hd[0][lane] = dc;
    hy[0][lane] = yc;
  }
  cluster.sync();
  const int c = g * kLanes + lane;
  if (heads && c > 0)
    prevc = cluster.map_shared_rank(&hp[0], (c - 1) >> 7)[(c - 1) & (kLanes - 1)];
#pragma unroll
  for (int t = 0; t < 10; ++t) {
    if (heads) {
      const int src = c + (1 << t);
      uint32_t ps = sent, ds = 0u, ys = 0u;
      if (src < kChains) {
        const int r = src >> 7;
        const int l = src & (kLanes - 1);
        ps = cluster.map_shared_rank(&hp[0], r)[l];
        ds = cluster.map_shared_rank(&hd[t & 1][0], r)[l];
        ys = cluster.map_shared_rank(&hy[t & 1][0], r)[l];
      }
      if (ps == pc && key_less(ds, ys, dc, yc)) {
        dc = ds;
        yc = ys;
      }
      hd[(t + 1) & 1][lane] = dc;
      hy[(t + 1) & 1][lane] = yc;
    }
    cluster.sync();  // also keeps every block alive while others read it
  }
  if (heads) {
    a.pid[row] = pc != prevc ? pc : sent;
    a.dep[row] = dc;
    a.pay[row] = yc;
  }
}

template <int POINTS, int MODE, int FMT>
cudaError_t launch(const Args& a, int batches, cudaStream_t stream) {
  auto kernel = project_kernel<POINTS, MODE, FMT>;
  const int smem = MODE == kRaw ? 0 : 3 * a.points * kPitch * 4;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        3 * kMaxPoints * kPitch * 4);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batches * kGroups);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (MODE == kChain) {  // the 8 groups of a batch share their heads
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kGroups;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

template <int MODE, int FMT>
cudaError_t launch_points(const Args& a, int batches, cudaStream_t stream) {
  switch (a.points) {  // the LOD buckets, fully unrolled
    case 16: return launch<16, MODE, FMT>(a, batches, stream);
    case 32: return launch<32, MODE, FMT>(a, batches, stream);
    case 48: return launch<48, MODE, FMT>(a, batches, stream);
    case 64: return launch<64, MODE, FMT>(a, batches, stream);
    default: return launch<0, MODE, FMT>(a, batches, stream);
  }
}

template <int FMT>
cudaError_t launch_mode(const Args& a, int batches, int chain_collapse, int collapse,
                        cudaStream_t stream) {
  if (!collapse) return launch<0, kRaw, FMT>(a, batches, stream);
  if (chain_collapse) return launch_points<kChain, FMT>(a, batches, stream);
  return launch_points<kCollapse, FMT>(a, batches, stream);
}

}  // namespace

extern "C" int pcr_project(const void* frame, const void* anchors,
                           const void* tbc, const void* lodn,
                           const void* coords, const void* colors_k,
                           const void* payload, void* pid, void* dep, void* pay,
                           int batches, int points, int width, int height,
                           int steps, int chain_collapse, int collapse, int fmt,
                           void* stream) {
  if (points < 1 || points > kMaxPoints) return static_cast<int>(cudaErrorInvalidValue);
  if (fmt < kBC1 || fmt > kRGB) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(frame), static_cast<const int*>(anchors),
               static_cast<const float*>(tbc), static_cast<const int*>(lodn),
               static_cast<const int*>(coords), static_cast<const uint32_t*>(colors_k),
               static_cast<const uint32_t*>(payload), static_cast<uint32_t*>(pid),
               static_cast<uint32_t*>(dep), static_cast<uint32_t*>(pay), points, width,
               height, steps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      payload       ? launch_mode<kPay>(a, batches, chain_collapse, collapse, s)
      : fmt == kBC7 ? launch_mode<kBC7>(a, batches, chain_collapse, collapse, s)
      : fmt == kRGB ? launch_mode<kRGB>(a, batches, chain_collapse, collapse, s)
                    : launch_mode<kBC1>(a, batches, chain_collapse, collapse, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}
