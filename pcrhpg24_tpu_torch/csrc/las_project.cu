// B11 on `.las`: the 10-10-10 unpack and projection of a frame's loaded
// batches for Hopper (sm_90a), one launch a frame.
//
// Replaces the reference's XLA `_project_101010`
// (pcrhpg24_tpu/render/methods/loop_las.py:225-279), for which it has no
// Pallas kernel, and the port's plain version of it
// (`render/methods/loop_las.py:project_101010`, ~200 unfused int32 and f32
// torch ops a frame).  Per point of batch b: level[b] picks the planes
// (level 0 joins the 10-bit fields of xyz4, xyz8 and xyz12 into 30 bits,
// level 1 those of xyz4 and xyz8 into 20, higher levels take xyz4's field
// alone over 1024 steps), `s * ((bmax - bmin) / denom) + bmin` places it
// in the batch's box, then `raster.project_points`' projection gives the
// linear pixel id (width*height where the point is dropped), the depth
// key (the f32 bits of w) and the payload (the point's global index).
// A culled batch (vis[b] == 0) reads no plane: pid width*height, depth 0,
// its indices as always; B3 and B4 never read the depth of an entry whose
// pid is >= width*height.
//
// Numerics: `project_101010`'s op order with explicitly rounded intrinsics
// (the library is built with -fmad=false): the int32 -> f32 conversion
// rounds to nearest, (bmax - bmin) / denom and cx / w are IEEE divisions,
// s * scale + bmin two rounded steps, ((t0*x + t1*y) + t2*z) + t3 for rows
// 0, 1 and 3, (ndc*0.5 + 0.5) * width truncated toward zero, and the clip
// tests in `project_points`' order.  The depth bits decide the image, so
// nothing here may contract or reassociate.
//
// Bound on the H100: device-memory bytes.  The least a frame moves is the
// 4-byte word of each plane its batch's level reads and the 12-byte (pid,
// depth, index) entry written for every point: at levels 2-4 16 B a point,
// 1.07 GB for 67.1M points, 0.32 ms at 3.35 TB/s; about 60 f32 and int
// instructions a point keep it under the bytes.  Design:
//  * a thread takes 4 consecutive points: one 16-byte evict-first load of
//    each plane it reads and one 16-byte store of each output word, so a
//    warp's loads and stores are whole 512-byte rows;
//  * a 256-thread block covers 1,024 points and so lies inside one
//    65,536-point batch: level, visibility and box are uniform over the
//    block, read once, and the plane branch never diverges;
//  * the planes a level does not need are never read: at levels 2-4 a
//    point costs one plane word of the three.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;                                 // one int4 a word
constexpr int kBatchPoints = 65536;                           // POINTS_PER_WORKGROUP
constexpr int kBlocksPerBatch = kBatchPoints / (kThreads * kPerThread);  // 64
constexpr uint32_t kField = 1023u;
constexpr float kSteps10 = 1024.0f;
constexpr float kSteps30 = 1073741824.0f;                     // 2**30

__device__ __forceinline__ uint32_t lane(const int4& w, int k) {
  return static_cast<uint32_t>(k == 0 ? w.x : k == 1 ? w.y : k == 2 ? w.z : w.w);
}

// ((t0*x + t1*y) + t2*z) + t3, each step rounded
__device__ __forceinline__ float row(const float* t, float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(t[0], x), __fmul_rn(t[1], y)),
                             __fmul_rn(t[2], z)), t[3]);
}

__global__ void __launch_bounds__(kThreads)
las_project_kernel(const int4* __restrict__ xyz4, const int4* __restrict__ xyz8,
                   const int4* __restrict__ xyz12, const int* __restrict__ level,
                   const int* __restrict__ vis, const float* __restrict__ bmin,
                   const float* __restrict__ bmax, const float* __restrict__ transform,
                   int4* __restrict__ pid, int4* __restrict__ dep, int4* __restrict__ idx,
                   int width, int height) {
  const int b = blockIdx.x / kBlocksPerBatch;
  const long long v = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int first = static_cast<int>(v * kPerThread);
  const int size = width * height;
  idx[v] = make_int4(first, first + 1, first + 2, first + 3);
  if (__ldg(vis + b) == 0) {
    pid[v] = make_int4(size, size, size, size);
    dep[v] = make_int4(0, 0, 0, 0);
    return;
  }
  const int lvl = __ldg(level + b);
  const bool lo = lvl >= 2;
  // the planes the level reads; the others stay zero, which is the
  // reference's selection (a4 | a8 | a12 at 0, a4 | a8 at 1, a4 above)
  const int4 zero = make_int4(0, 0, 0, 0);
  const int4 w4 = __ldcs(xyz4 + v);
  const int4 w8 = lvl == 0 || lvl == 1 ? __ldcs(xyz8 + v) : zero;
  const int4 w12 = lvl == 0 ? __ldcs(xyz12 + v) : zero;
  const float denom = lo ? kSteps10 : kSteps30;
  float mn[3], scale[3], t[12];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    mn[a] = __ldg(bmin + 3 * b + a);
    scale[a] = __fdiv_rn(__fsub_rn(__ldg(bmax + 3 * b + a), mn[a]), denom);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // rows 0, 1 and 3 of the wvp
    t[j] = __ldg(transform + j);
    t[4 + j] = __ldg(transform + 4 + j);
    t[8 + j] = __ldg(transform + 12 + j);
  }
  int out_pid[kPerThread], out_dep[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const uint32_t p4 = lane(w4, k), p8 = lane(w8, k), p12 = lane(w12, k);
    float pos[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int sh = 10 * a;
      const uint32_t s = (((p4 >> sh) & kField) << 20) | (((p8 >> sh) & kField) << 10) |
                         ((p12 >> sh) & kField);
      const int si = static_cast<int>(lo ? s >> 20 : s);
      pos[a] = __fadd_rn(__fmul_rn(__int2float_rn(si), scale[a]), mn[a]);
    }
    const float cx = row(t, pos[0], pos[1], pos[2]);
    const float cy = row(t + 4, pos[0], pos[1], pos[2]);
    const float w = row(t + 8, pos[0], pos[1], pos[2]);
    const float ndx = __fdiv_rn(cx, w);
    const float ndy = __fdiv_rn(cy, w);
    bool ok = (w > 0.0f) && (fabsf(ndx) <= 1.0f) && (fabsf(ndy) <= 1.0f);
    // truncation toward zero, as torch's f32 -> int32; the value matters
    // only where ok already holds (finite, |ndc| <= 1)
    const int sx = __float2int_rz(
        __fmul_rn(__fadd_rn(__fmul_rn(ndx, 0.5f), 0.5f), static_cast<float>(width)));
    const int sy = __float2int_rz(
        __fmul_rn(__fadd_rn(__fmul_rn(ndy, 0.5f), 0.5f), static_cast<float>(height)));
    ok = ok && sx >= 0 && sx < width && sy >= 0 && sy < height;
    out_pid[k] = ok ? sx + sy * width : size;
    out_dep[k] = __float_as_int(w);
  }
  pid[v] = make_int4(out_pid[0], out_pid[1], out_pid[2], out_pid[3]);
  dep[v] = make_int4(out_dep[0], out_dep[1], out_dep[2], out_dep[3]);
}

}  // namespace

// B11 over the first `batches` batches: xyz4/8/12 the int32 planes (16-byte
// aligned), level and vis (B,) int32, bmin and bmax (B, 3) f32, transform
// the (4, 4) f32 wvp, all on the device; pid, dep and idx (batches * 65536,)
// int32 outputs.
extern "C" int pcr_las_project(const void* xyz4, const void* xyz8, const void* xyz12,
                               const void* level, const void* vis, const void* bmin,
                               const void* bmax, const void* transform, void* pid, void* dep,
                               void* idx, int batches, int width, int height, void* stream) {
  if (batches <= 0) return 0;
  las_project_kernel<<<batches * kBlocksPerBatch, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(xyz4), static_cast<const int4*>(xyz8),
      static_cast<const int4*>(xyz12), static_cast<const int*>(level),
      static_cast<const int*>(vis), static_cast<const float*>(bmin),
      static_cast<const float*>(bmax), static_cast<const float*>(transform),
      static_cast<int4*>(pid), static_cast<int4*>(dep), static_cast<int4*>(idx), width,
      height);
  return static_cast<int>(cudaGetLastError());
}
