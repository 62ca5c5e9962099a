// Affine patch resampling and Baumberg adaptation for Hopper (sm_90a).
//
// CUDA counterparts of the four Pallas kernels in the JAX package's
// ops/pallas_patch.py:
//   resample_pyr   <- dma_hat_resample   (_dma_resample_kernel, _resample_one)
//   resample_win   <- hat_resample       (_resample_kernel)
//   baumberg_pyr   <- dma_baumberg       (_dma_baumberg_kernel)
//   baumberg_win   <- baumberg_pallas    (_baumberg_kernel)
//
// The "pyr" variants read a [L,H,W] stack in place through a per-keypoint
// level and (8,128)-aligned window origin; the "win" variants read
// precropped [n,W,W] windows.  One sampling body serves both, templated on
// the window source.  Samples are exact 4-tap bilinear straight from global
// memory, zero outside the level or the window, under the same test as the
// Pallas code (image bounds with floor(g) < l-1; window bounds p >= 0,
// px < WX-1, py < WY-1).  The hat-matrix contraction of the TPU kernels is
// not carried over: it only existed to feed the MXU.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// -shared -Xcompiler -fPIC (no fast math: IEEE sqrtf and 1/sqrtf, and no
// contraction into FMAs, so the arithmetic rounds op by op like the plain
// PyTorch versions in ops/patch_kernels.py).  Every entry point launches
// on the given stream of the current device (the caller makes the tensors'
// device current), allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// Window sources
// ---------------------------------------------------------------------------
// [L,H,W] stack read in place: window of keypoint k starts at (oy[k], ox[k])
// of level lev[k].  The wrapper guarantees the window lies in the stack.
struct PyrSrc {
  const float* stack;
  int H, W;
  const int* lev;
  const int* oy;
  const int* ox;
  int WY, WX;
  static constexpr bool kXFirst = true;  // x taps combined first (as _resample_one)
  __device__ __forceinline__ const float* base(int k) const {
    return stack + ((size_t)lev[k] * H + oy[k]) * (size_t)W + ox[k];
  }
  __device__ __forceinline__ int stride() const { return W; }
};

// [n,Wn,Wn] precropped windows.
struct WinSrc {
  const float* wins;
  int Wn;
  int WY, WX;  // both Wn
  static constexpr bool kXFirst = false;  // y taps first (as _resample_kernel)
  __device__ __forceinline__ const float* base(int k) const {
    return wins + (size_t)k * Wn * Wn;
  }
  __device__ __forceinline__ int stride() const { return Wn; }
};

// One bilinear sample at window-local (px, py); (ox, oy) is the window
// origin in level coordinates and (lw, lh) the level extent.
template <class Src>
__device__ __forceinline__ float sample(const Src& src, const float* win,
                                        float px, float py, float ox, float oy,
                                        float lw, float lh) {
  const float gx = px + ox;
  const float gy = py + oy;
  const bool inb = (gx >= 0.0f) && (gy >= 0.0f) &&
                   (floorf(gx) < lw - 1.0f) && (floorf(gy) < lh - 1.0f) &&
                   (px >= 0.0f) && (py >= 0.0f) &&
                   (px < (float)src.WX - 1.0f) && (py < (float)src.WY - 1.0f);
  if (!inb) return 0.0f;
  const float fx0 = floorf(px);
  const float fy0 = floorf(py);
  const int x0 = (int)fx0;
  const int y0 = (int)fy0;
  // the two nonzero tent weights of each axis, as the hat matrices hold them
  const float wx0 = 1.0f - fabsf(px - fx0);
  const float wx1 = 1.0f - fabsf(px - (fx0 + 1.0f));
  const float wy0 = 1.0f - fabsf(py - fy0);
  const float wy1 = 1.0f - fabsf(py - (fy0 + 1.0f));
  const int s = src.stride();
  const float* r0 = win + (size_t)y0 * s + x0;
  const float* r1 = r0 + s;
  const float v00 = __ldg(r0), v01 = __ldg(r0 + 1);
  const float v10 = __ldg(r1), v11 = __ldg(r1 + 1);
  if (Src::kXFirst) {
    return (wx0 * v00 + wx1 * v01) * wy0 + (wx0 * v10 + wx1 * v11) * wy1;
  }
  return (wy0 * v00 + wy1 * v10) * wx0 + (wy0 * v01 + wy1 * v11) * wx1;
}

// ---------------------------------------------------------------------------
// Resample: one thread per output sample, grid (keypoint, sample tile).
// params [n, ncols]: cxl cyl a00 a01 a10 a11 ox oy lw lh [live]
// ---------------------------------------------------------------------------
template <class Src>
__global__ void resample_kernel(Src src, const float* __restrict__ params,
                                int ncols, int live_col, int P,
                                float* __restrict__ out) {
  const int k = blockIdx.x;
  const int f = blockIdx.y * blockDim.x + threadIdx.x;
  const int P2 = P * P;
  if (f >= P2) return;
  const float* pr = params + (size_t)k * ncols;
  float* o = out + (size_t)k * P2 + f;
  if (live_col >= 0 && !(pr[live_col] > 0.5f)) {  // dead rows are all zeros
    *o = 0.0f;
    return;
  }
  const float c = (float)(P / 2);
  const float jg = (float)(f / P) - c;  // row (y)
  const float ig = (float)(f % P) - c;  // col (x)
  const float px = pr[0] + ig * pr[2] + jg * pr[3];
  const float py = pr[1] + ig * pr[4] + jg * pr[5];
  *o = sample(src, src.base(k), px, py, pr[6], pr[7], pr[8], pr[9]);
}

// ---------------------------------------------------------------------------
// Baumberg: one block per keypoint, one thread per patch sample.
// params [n, ncols]: cxl cyl ratio valid ox oy lw lh
// ---------------------------------------------------------------------------
struct BState {
  float u11, u12, u21, u22;
  float ratio_bef;
  int done, ok;
  float o11, o12, o21, o22;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <class Src>
__global__ void baumberg_kernel(Src src, const float* __restrict__ params,
                                int ncols, const float* __restrict__ mask,
                                int ws, int max_iter, float conv,
                                float* __restrict__ U, uint8_t* __restrict__ ok) {
  extern __shared__ float patch[];  // ws*ws
  __shared__ float red[3][32];
  __shared__ BState st;
  const int k = blockIdx.x;
  const int t = threadIdx.x;
  const int ws2 = ws * ws;
  const float* pr = params + (size_t)k * ncols;
  const float cxl = pr[0], cyl = pr[1], ratio = pr[2];
  const float ox = pr[4], oy = pr[5], lw = pr[6], lh = pr[7];
  if (t == 0) {
    st.u11 = 1.0f; st.u12 = 0.0f; st.u21 = 0.0f; st.u22 = 1.0f;
    st.ratio_bef = 0.0f;
    st.done = !(pr[3] > 0.5f);
    st.ok = 0;
    st.o11 = 1.0f; st.o12 = 0.0f; st.o21 = 0.0f; st.o22 = 1.0f;
  }
  __syncthreads();
  const float* win = st.done ? nullptr : src.base(k);
  const float c = (float)(ws / 2);
  const int i = t % ws, j = t / ws;
  const float ig = (float)i - c, jg = (float)j - c;
  const float m = t < ws2 ? mask[t] : 0.0f;
  const float n_mask = (float)ws2;

  for (int it = 0; it < max_iter; ++it) {
    if (st.done) break;  // per-keypoint early exit (uniform in the block)
    if (t < ws2) {
      const float a00 = st.u11 * ratio, a01 = st.u12 * ratio;
      const float a10 = st.u21 * ratio, a11 = st.u22 * ratio;
      const float px = cxl + ig * a00 + jg * a01;
      const float py = cyl + ig * a10 + jg * a11;
      patch[t] = sample(src, win, px, py, ox, oy, lw, lh);
    }
    __syncthreads();
    float s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
    if (t < ws2) {
      const float* row = patch + j * ws;
      const float fx = i == 0 ? row[1] - row[0]
                     : i == ws - 1 ? row[ws - 1] - row[ws - 2]
                     : row[i + 1] - row[i - 1];
      const float fy = j == 0 ? patch[ws + i] - patch[i]
                     : j == ws - 1 ? patch[(ws - 1) * ws + i] - patch[(ws - 2) * ws + i]
                     : patch[(j + 1) * ws + i] - patch[(j - 1) * ws + i];
      s1 = fx * fx * m;
      s2 = fx * fy * m;
      s3 = fy * fy * m;
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    s3 = warp_sum(s3);
    const int lane = t & 31, wid = t >> 5;
    if (lane == 0) { red[0][wid] = s1; red[1][wid] = s2; red[2][wid] = s3; }
    __syncthreads();
    if (t == 0) {
      float a = 0.0f, b = 0.0f, cc = 0.0f;
      const int nw = (blockDim.x + 31) >> 5;
      for (int w = 0; w < nw; ++w) { a += red[0][w]; b += red[1][w]; cc += red[2][w]; }
      a = a / n_mask;
      b = b / n_mask;
      cc = cc / n_mask;
      // inverse square root of SPD [[a,b],[b,cc]], det 1 (helpers.cpp:463-502)
      float r_ = 1.0f, tq = 0.0f, rr = 1.0f;
      if (b != 0.0f) {
        r_ = (cc - a) / (2.0f * b);
        tq = r_ >= 0.0f ? 1.0f / (r_ + sqrtf(1.0f + r_ * r_))
                        : -1.0f / (-r_ + sqrtf(1.0f + r_ * r_));
        rr = 1.0f / sqrtf(1.0f + tq * tq);
      }
      const float tt = tq * rr;
      float x = 1.0f / sqrtf(rr * rr * a - 2.0f * rr * tt * b + tt * tt * cc);
      float z = 1.0f / sqrtf(tt * tt * a + 2.0f * rr * tt * b + rr * rr * cc);
      const float d = sqrtf(x * z);
      x = x / d;
      z = z / d;
      const float l1 = x > z ? x : z;
      const float l2 = x > z ? z : x;
      const float na = rr * rr * x + tt * tt * z;
      const float nb = -rr * tt * x + tt * rr * z;
      const float nc = tt * tt * x + rr * rr * z;
      const bool nan_bad = !(isfinite(na) && isfinite(nb) && isfinite(nc));
      const float ratio_act = 1.0f - l2 / l1;
      const float v11 = na * st.u11 + nb * st.u21;
      const float v12 = na * st.u12 + nb * st.u22;
      const float v21 = nb * st.u11 + nc * st.u21;
      const float v22 = nb * st.u12 + nc * st.u22;
      // eigenvalues of the new u (helpers.cpp:504-515)
      const float trace = v11 + v22;
      const float delta1 = trace * trace - 4.0f * (v11 * v22 - v12 * v21);
      const bool eok = delta1 >= 0.0f;
      const float delta = sqrtf(fmaxf(delta1, 0.0f));
      const float e1 = (trace + delta) / 2.0f;
      const float e2 = (trace - delta) / 2.0f;
      const bool aniso_bad = !eok || (e1 / e2 > 6.0f) || (e2 / e1 > 6.0f);
      const bool converged = (ratio_act < conv) && (st.ratio_bef < conv);
      if (!nan_bad && !aniso_bad && converged) {
        st.o11 = v11; st.o12 = v12; st.o21 = v21; st.o22 = v22;
        st.ok = 1;
        st.done = 1;
      } else if (nan_bad || aniso_bad) {
        st.done = 1;
      }
      st.u11 = v11; st.u12 = v12; st.u21 = v21; st.u22 = v22;
      st.ratio_bef = ratio_act;
    }
    __syncthreads();
  }
  if (t == 0) {
    float* u = U + (size_t)k * 4;
    u[0] = st.o11; u[1] = st.o12; u[2] = st.o21; u[3] = st.o22;
    ok[k] = (uint8_t)st.ok;
  }
}

inline int round_up32(int v) { return (v + 31) / 32 * 32; }

}  // namespace

// ---------------------------------------------------------------------------
// C interface (bound with ctypes)
// ---------------------------------------------------------------------------
extern "C" {

int resample_pyr(const float* stack, int H, int W, const int* lev,
                 const int* oy, const int* ox, const float* params, int ncols,
                 int live_col, int n, int P, int WY, int WX, float* out,
                 void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  PyrSrc src{stack, H, W, lev, oy, ox, WY, WX};
  const int threads = 128;
  dim3 grid(n, (P * P + threads - 1) / threads);
  resample_kernel<PyrSrc><<<grid, threads, 0, (cudaStream_t)stream>>>(
      src, params, ncols, live_col, P, out);
  return (int)cudaGetLastError();
}

int resample_win(const float* wins, int Wn, const float* params,
                 int ncols, int n, int P, float* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  WinSrc src{wins, Wn, Wn, Wn};
  const int threads = 128;
  dim3 grid(n, (P * P + threads - 1) / threads);
  resample_kernel<WinSrc><<<grid, threads, 0, (cudaStream_t)stream>>>(
      src, params, ncols, -1, P, out);
  return (int)cudaGetLastError();
}

int baumberg_pyr(const float* stack, int H, int W, const int* lev,
                 const int* oy, const int* ox, const float* params, int ncols,
                 const float* mask, int ws, int max_iter, float conv, int n,
                 int WY, int WX, float* U, uint8_t* ok, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  PyrSrc src{stack, H, W, lev, oy, ox, WY, WX};
  baumberg_kernel<PyrSrc><<<n, round_up32(ws * ws), ws * ws * sizeof(float),
                            (cudaStream_t)stream>>>(
      src, params, ncols, mask, ws, max_iter, conv, U, ok);
  return (int)cudaGetLastError();
}

int baumberg_win(const float* wins, int Wn, const float* params,
                 int ncols, const float* mask, int ws, int max_iter, float conv,
                 int n, float* U, uint8_t* ok, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  WinSrc src{wins, Wn, Wn, Wn};
  baumberg_kernel<WinSrc><<<n, round_up32(ws * ws), ws * ws * sizeof(float),
                            (cudaStream_t)stream>>>(
      src, params, ncols, mask, ws, max_iter, conv, U, ok);
  return (int)cudaGetLastError();
}

}  // extern "C"
