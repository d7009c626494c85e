// The card's counterpart of the TPU probe `experiments/r3_div_parity.py`
// (its pallas_calls at :32, `kernel`, and :62, `kernel2`): which f32 forms
// keep B2's bits.  B2 (`csrc/project.cu:222-243`) computes every step with
// an explicitly rounded intrinsic (and the library is built with
// -fmad=false): w = ((t0*x + t1*y) + t2*z) + tb, inv = 1/w as an IEEE
// division, ndc = c*inv, px = trunc((ndc*0.5 + 0.5)*width).  Its depth
// key is w's bits and its pixel comes from px, so a faster form is
// usable only where its bits are B2's.  Two op groups, each op and form a
// template value:
//  - the division group (`:32`): kInv 1/w, kMul x*(1/w), kCastProbe
//    (int)(((x*(1/w))*0.5)*1920), kCastB2 (int)((((x*(1/w))*0.5)+0.5)*width),
//    each with 1/w as kDivRn (`__fdiv_rn(1, w)`, B2's), kRcpRn
//    (`__frcp_rn`), kFdividef (`__fdividef(1, w)`) or kRcpApprox (PTX
//    `rcp.approx.ftz.f32`); and kDiv x/w as kDivRn, kFdividef or x times
//    kRcpApprox;
//  - the affine group (`:62`): kAffine t0*a + t1*b + t2*c + t3 as kPerOp
//    (B2's order), kFmaChain (fmaf(t2, c, fmaf(t1, b, t0*a)) + t3) or kFmaAll
//    (fmaf(t2, c, fmaf(t1, b, fmaf(t0, a, t3)))); t3 is d[i >> dshift] (a
//    constant, or B2's per-batch translation).
// A float result is written as its bits, a cast as the int (cvt.rzi
// saturates, NaN gives 0).  With steps > 0 each element runs a dependent
// chain of `steps` ops (kInv: v = 1/v from w; kMul: v = x*(1/v); kDiv: v =
// x/v; kAffine: v = t0*v + t1*b + t2*c + t3 from a), so that each form's
// instruction cost shows through the memory bound.
//
// Bound: the inputs read and the output written once (elementwise); the
// dependent chains are bound by their ops' latency.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Op : int { kInv = 0, kMul = 1, kCastProbe = 2, kCastB2 = 3, kDiv = 4, kAffine = 5 };
enum DivForm : int { kDivRn = 0, kRcpRn = 1, kFdividef = 2, kRcpApprox = 3 };
enum AffineForm : int { kPerOp = 0, kFmaChain = 1, kFmaAll = 2 };

__device__ __forceinline__ float rcp_approx(float w) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(w));
  return r;
}

template <int F>
__device__ __forceinline__ float inv_of(float w) {
  if constexpr (F == kDivRn) return __fdiv_rn(1.0f, w);
  else if constexpr (F == kRcpRn) return __frcp_rn(w);
  else if constexpr (F == kFdividef) return __fdividef(1.0f, w);
  else return rcp_approx(w);
}

template <int F>
__device__ __forceinline__ float div_of(float x, float w) {
  if constexpr (F == kDivRn) return __fdiv_rn(x, w);
  else if constexpr (F == kFdividef) return __fdividef(x, w);
  else return __fmul_rn(x, rcp_approx(w));
}

template <int F>
__device__ __forceinline__ float affine(float a, float b, float c, float t0, float t1,
                                        float t2, float t3) {
  if constexpr (F == kPerOp)
    return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(t0, a), __fmul_rn(t1, b)), __fmul_rn(t2, c)),
                     t3);
  else if constexpr (F == kFmaChain)
    return __fadd_rn(__fmaf_rn(t2, c, __fmaf_rn(t1, b, __fmul_rn(t0, a))), t3);
  else
    return __fmaf_rn(t2, c, __fmaf_rn(t1, b, __fmaf_rn(t0, a, t3)));
}

template <int O, int F, bool kDependent>
__global__ void __launch_bounds__(256)
parity_kernel(const float* __restrict__ in0, const float* __restrict__ in1,
              const float* __restrict__ in2, const float* __restrict__ t,
              const float* __restrict__ d, int dshift, int width, long long n, int steps,
              int* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float a = in0[i];
  if constexpr (O == kAffine) {
    const float b = in1[i], c = in2[i], t0 = t[0], t1 = t[1], t2 = t[2], t3 = d[i >> dshift];
    float v = affine<F>(a, b, c, t0, t1, t2, t3);
    if constexpr (kDependent)
      for (int s = 1; s < steps; ++s) v = affine<F>(v, b, c, t0, t1, t2, t3);
    out[i] = __float_as_int(v);
  } else {
    const float w = a, x = in1[i];
    if constexpr (O == kInv) {
      float v = inv_of<F>(w);
      if constexpr (kDependent)
        for (int s = 1; s < steps; ++s) v = inv_of<F>(v);
      out[i] = __float_as_int(v);
    } else if constexpr (O == kMul) {
      float v = __fmul_rn(x, inv_of<F>(w));
      if constexpr (kDependent)
        for (int s = 1; s < steps; ++s) v = __fmul_rn(x, inv_of<F>(v));
      out[i] = __float_as_int(v);
    } else if constexpr (O == kDiv) {
      float v = div_of<F>(x, w);
      if constexpr (kDependent)
        for (int s = 1; s < steps; ++s) v = div_of<F>(x, v);
      out[i] = __float_as_int(v);
    } else if constexpr (O == kCastProbe) {
      out[i] = static_cast<int>(__fmul_rn(__fmul_rn(__fmul_rn(x, inv_of<F>(w)), 0.5f), 1920.0f));
    } else {
      out[i] = static_cast<int>(__fmul_rn(
          __fadd_rn(__fmul_rn(__fmul_rn(x, inv_of<F>(w)), 0.5f), 0.5f),
          static_cast<float>(width)));
    }
  }
}

template <int O, int F, bool kDependent>
int launch(const void* in0, const void* in1, const void* in2, const void* t, const void* d,
           int dshift, int width, long long n, int steps, void* out, cudaStream_t s) {
  const long long blocks = (n + 255) / 256;
  parity_kernel<O, F, kDependent><<<static_cast<unsigned>(blocks), 256, 0, s>>>(
      static_cast<const float*>(in0), static_cast<const float*>(in1),
      static_cast<const float*>(in2), static_cast<const float*>(t),
      static_cast<const float*>(d), dshift, width, n, steps, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define PCR_PARITY_CASE(O, F)                                                              \
  if (op == (O) && form == (F))                                                            \
    return steps > 0 ? launch<(O), (F), true>(in0, in1, in2, t, d, dshift, width, n, steps, \
                                              out, s)                                      \
                     : launch<(O), (F), false>(in0, in1, in2, t, d, dshift, width, n, 1,    \
                                               out, s);
#define PCR_PARITY_ONCE(O, F) \
  if (op == (O) && form == (F) && steps == 0) \
    return launch<(O), (F), false>(in0, in1, in2, t, d, dshift, width, n, 1, out, s);

// n elements of op at form (`steps` > 0: a dependent chain of that many
// ops an element; the casts run once only).
extern "C" int pcr_probe_parity(int op, int form, int steps, const void* in0,
                                const void* in1, const void* in2, const void* t,
                                const void* d, int dshift, int width, long long n, void* out,
                                void* stream) {
  if (n < 1 || n > (1ll << 31) || steps < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  PCR_PARITY_CASE(kInv, kDivRn);
  PCR_PARITY_CASE(kInv, kRcpRn);
  PCR_PARITY_CASE(kInv, kFdividef);
  PCR_PARITY_CASE(kInv, kRcpApprox);
  PCR_PARITY_CASE(kMul, kDivRn);
  PCR_PARITY_CASE(kMul, kRcpRn);
  PCR_PARITY_CASE(kMul, kFdividef);
  PCR_PARITY_CASE(kMul, kRcpApprox);
  PCR_PARITY_CASE(kDiv, kDivRn);
  PCR_PARITY_CASE(kDiv, kFdividef);
  PCR_PARITY_CASE(kDiv, kRcpApprox);
  PCR_PARITY_CASE(kAffine, kPerOp);
  PCR_PARITY_CASE(kAffine, kFmaChain);
  PCR_PARITY_CASE(kAffine, kFmaAll);
  PCR_PARITY_ONCE(kCastProbe, kDivRn);
  PCR_PARITY_ONCE(kCastProbe, kRcpRn);
  PCR_PARITY_ONCE(kCastProbe, kFdividef);
  PCR_PARITY_ONCE(kCastProbe, kRcpApprox);
  PCR_PARITY_ONCE(kCastB2, kDivRn);
  PCR_PARITY_ONCE(kCastB2, kRcpRn);
  PCR_PARITY_ONCE(kCastB2, kFdividef);
  PCR_PARITY_ONCE(kCastB2, kRcpApprox);
  return static_cast<int>(cudaErrorInvalidValue);
}
