// Affine patch resampling, Baumberg adaptation and an octave's extrema for
// Hopper (sm_90a).
//
// The library's five C entries: the CUDA counterparts of the four Pallas
// kernels in the JAX package's ops/pallas_patch.py,
//   resample_pyr   <- dma_hat_resample   (_dma_resample_kernel, _resample_one)
//   resample_win   <- hat_resample       (_resample_kernel)
//   baumberg_pyr   <- dma_baumberg       (_dma_baumberg_kernel)
//   baumberg_win   <- baumberg_pallas    (_baumberg_kernel)
// and octave_extrema (below), which has no Pallas counterpart.
//
// The "pyr" variants read a [L,H,W] stack in place through a per-keypoint
// level and (8,128)-aligned window origin; the "win" variants read
// precropped [n,W,W] windows.  Samples are exact 4-tap bilinear, zero
// outside the level or the window, under the same test as the Pallas code
// (image bounds with floor(g) < l-1; window bounds p >= 0, px < WX-1,
// py < WY-1).  The hat-matrix contraction of the TPU kernels is not
// carried over: it only existed to feed the MXU.
//
// What bounds each kernel on this card, and what its design does about it:
//
// resample_pyr (resample_stage_kernel).  By bytes on paper (the [n,P,P]
// output: a launch whose rows are all dead runs at the card's write rate),
// but what a live keypoint costs is instructions issued and the latency of
// a block's chain (read the row, plan, copy, sample), not bytes.  So one
// block of 128 threads owns one keypoint, and many small blocks are
// resident, in different phases.  One warp reads the keypoint's params,
// level and origin and plans it: the bounding box of the patch's four
// corners (sample positions are monotone in the patch row and column, also
// after rounding, so the corners bound every sample), clipped to the
// window; the other warps read the plan from shared memory (all of them
// planning issued as many instructions as the sampling itself).  The box
// is staged into shared memory with coalesced 16-byte cp.async copies; a
// thread owns one patch column and walks over rows, so the column's part
// of the position is computed once and the thread's place comes from a
// multiplication, not a division; where the extreme positions pass the
// window test every sample does, and the loop leaves the test out; taps
// come from shared memory; the output goes out as coalesced streaming
// stores that do not push the pyramid out of the L2.  A dead row, or a box
// that no sample can be admitted from, is zero-filled with 16-byte stores
// and touches no source.  A box larger than the staging buffer (no pyramid
// level fits the patch) takes its taps from global memory in the same
// kernel, with the same arithmetic.
//
// baumberg_pyr (baumberg_warp_kernel).  By latency: up to max_iter
// dependent iterations per keypoint, a few KB read and 20 bytes written;
// the launch lasts as long as its slowest keypoints' chains.  One warp
// owns one keypoint: each lane samples ws*ws/32 patch positions (unrolled,
// so their taps are in flight together), the patch lives in the warp's
// slab of shared memory for the gradient, guarded by __syncwarp only, the
// three second-moment sums are reduced by xor shuffles so that every lane
// holds the totals, and every lane runs the 2x2 update itself: no
// block-wide barrier, no broadcast.  Blocks are small, so a keypoint that
// converges early frees its place for the next one.  The order of the
// float sums is fixed (lane partials in sample order, then the butterfly),
// so results repeat bit for bit.  The taps are read outside any branch
// (sample_unbranched), so that the loads of a lane's samples overlap.
//
// resample_win (resample_stage_kernel on precropped windows).  The same
// kernel as resample_pyr, templated on the window source: a window is its
// own level-0 origin, its row is Wn floats, it has no live column, and the
// y taps are combined first (as _resample_kernel does).  The box is copied
// 16 bytes wide when Wn is a multiple of 4 and the windows start on a
// 16-byte line, else 4 bytes wide.  A window is contiguous and read once,
// so staging pays only for wide patches (many samples to a box): the
// wrapper passes stage_floats = 0 for narrow ones, and every tap then comes
// from global memory in the same kernel.
//
// The wide-patch path (resample_kernel).  A patch wider than a block has
// threads for its columns (P > kResampleThreads) is resampled, from either
// source, by one thread per output sample with taps from global memory.
// No main path's patch is that wide.
//
// baumberg_win (baumberg_block_kernel).  By latency, like baumberg_pyr; at
// the few hundred keypoints of a small octave the launch lasts exactly as
// long as one keypoint's chain, so what has to be short is one iteration of
// one keypoint.
// kBaumbergWinWarps warps (4) share a keypoint: a thread samples 3 of the
// 19x19 positions with the taps of all three read outside any branch
// (behind the window test's branch each sample's loads waited for the one
// before), the patch lies in one slab of shared memory, each warp reduces
// its threads' three SMM sums by the xor butterfly and its lane 0 writes
// them, and every thread adds the warps' totals in warp order and runs the
// 2x2 update on its own registers.  That is two block-wide barriers an
// iteration (patch complete; totals complete), no thread that works while
// the others wait and no state passed through shared memory.  One slab is
// enough: it is next written after the second barrier, and was last read
// before it.  Every thread holds the same state, so the block leaves the
// loop together.  The sums have a fixed order (a thread's partials in
// sample order, the butterfly, the warps in order), so results repeat bit
// for bit.  What is left of an iteration is mostly the update's chain of
// IEEE divides and square roots, which every warp of the block repeats.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// -shared -Xcompiler -fPIC (no fast math: IEEE sqrtf and 1/sqrtf, and no
// contraction into FMAs, so the arithmetic rounds op by op like the plain
// PyTorch versions in ops/patch_kernels.py).  Every entry point launches
// on the given stream of the current device (the caller makes the tensors'
// device current), allocates nothing and returns cudaGetLastError().
//
// octave_extrema (five kernels, no Pallas counterpart) replaces the eager
// chain of detect/pyramid.py for one octave's [L,H,W] response stack:
// find_extrema (3x3x3 NMS, scan-order compaction cut at k candidates),
// localize (five subpixel iterations) and dedup_octave_map.  Eagerly that
// is about 900 small ATen launches and a host read (torch.nonzero) an
// octave; the device work behind them is one read of the stack and a few
// hundred flops a candidate.  So the design is launch-bound: five launches,
// no host round trip, the count of extrema left on the device.
//   1. extrema_mark_kernel: a block owns a tile of kExtTile cells of the
//      flattened middle levels, in scan order; a thread tests a cell
//      against its 26 neighbours (rows and columns wrap as torch.roll
//      does; any NaN among the 27 makes no extremum, as NaN spreads
//      through torch.maximum); a warp ballot gives a bit word per 32 cells,
//      and the block writes its tile's count.  It also fills the octave's
//      cell map with INT_MAX.
//   2. extrema_scan_kernel: one block scans the tile counts into offsets
//      and writes the number of extrema.
//   3. extrema_scatter_kernel: a tile writes the flat indices of its
//      extrema at its offset plus their rank in the tile, up to k; tiles
//      past k return at once.
//   4. extrema_localize_kernel: a thread per candidate slot runs the five
//      iterations in registers, every float expression in localize's
//      order, one rounding per ATen op (x*x for ** 2, bs * (1/S) where ATen
//      divides by a CPU scalar), and claims its final cell with atomicMin
//      of its slot.  Slots past the extrema take flat index 0, as the
//      plain version's zero padding does.
//   5. extrema_keep_kernel: a slot stays valid where it holds its cell's
//      claim: the first accepted candidate in scan order (pyramid.cpp:
//      387-391).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kResampleThreads = 128;  // threads of a resample block (one keypoint)
constexpr int kBaumbergWarps = 2;      // keypoints (warps) of a baumberg_pyr block
constexpr int kBaumbergUnroll = 12;    // unrolling of the loops over a lane's samples
constexpr int kBaumbergWinWarps = 4;   // warps that share a keypoint of baumberg_win

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
  // the window's first element, and the column of the source's row it is in
  __device__ __forceinline__ void locate(int k, const float*& win, int& col) const {
    const int l = __ldg(lev + k), y = __ldg(oy + k);
    col = __ldg(ox + k);
    win = stack + ((size_t)l * H + y) * (size_t)W + col;
  }
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
  __device__ __forceinline__ void locate(int k, const float*& win, int& col) const {
    col = 0;
    win = base(k);
  }
};

// ---------------------------------------------------------------------------
// One bilinear sample
// ---------------------------------------------------------------------------
// Whether the sample at window-local (px, py) is taken: (ox, oy) is the
// window origin in level coordinates, (lw, lh) the level extent and
// (wxm1, wym1) the window extent less one.
__device__ __forceinline__ bool admitted(float px, float py, float ox, float oy,
                                         float lw, float lh, float wxm1,
                                         float wym1) {
  const float gx = px + ox;
  const float gy = py + oy;
  return (gx >= 0.0f) && (gy >= 0.0f) &&
         (floorf(gx) < lw - 1.0f) && (floorf(gy) < lh - 1.0f) &&
         (px >= 0.0f) && (py >= 0.0f) && (px < wxm1) && (py < wym1);
}

// Taps straight from a window in global memory, through the read-only cache.
struct GlobalTaps {
  const float* win;
  int stride;
  __device__ __forceinline__ void operator()(int y0, int x0, float& v00,
                                             float& v01, float& v10,
                                             float& v11) const {
    const float* r0 = win + (size_t)y0 * stride + x0;
    const float* r1 = r0 + stride;
    v00 = __ldg(r0); v01 = __ldg(r0 + 1);
    v10 = __ldg(r1); v11 = __ldg(r1 + 1);
  }
};

// Taps from a box of the window staged in shared memory: tile[0] holds
// window position (ylo, xlo); off = -(ylo * pitch + xlo).
struct TileTaps {
  const float* tile;
  int pitch, off;
  __device__ __forceinline__ void operator()(int y0, int x0, float& v00,
                                             float& v01, float& v10,
                                             float& v11) const {
    const int at = y0 * pitch + (x0 + off);
    v00 = tile[at]; v01 = tile[at + 1];
    v10 = tile[at + pitch]; v11 = tile[at + pitch + 1];
  }
};

// The 4-tap bilinear value of an admitted sample: the two nonzero tent
// weights of each axis, as the hat matrices hold them.
template <bool kXFirst, class Taps>
__device__ __forceinline__ float bilinear(float px, float py, const Taps& taps) {
  const float fx0 = floorf(px);
  const float fy0 = floorf(py);
  const float wx0 = 1.0f - fabsf(px - fx0);
  const float wx1 = 1.0f - fabsf(px - (fx0 + 1.0f));
  const float wy0 = 1.0f - fabsf(py - fy0);
  const float wy1 = 1.0f - fabsf(py - (fy0 + 1.0f));
  float v00, v01, v10, v11;
  taps((int)fy0, (int)fx0, v00, v01, v10, v11);
  if (kXFirst) {
    return (wx0 * v00 + wx1 * v01) * wy0 + (wx0 * v10 + wx1 * v11) * wy1;
  }
  return (wy0 * v00 + wy1 * v10) * wx0 + (wy0 * v01 + wy1 * v11) * wx1;
}

// One sample of window `win` of `src`, taps from global memory.
template <class Src>
__device__ __forceinline__ float sample(const Src& src, const float* win,
                                        float px, float py, float ox, float oy,
                                        float lw, float lh) {
  if (!admitted(px, py, ox, oy, lw, lh, (float)src.WX - 1.0f,
                (float)src.WY - 1.0f)) {
    return 0.0f;
  }
  return bilinear<Src::kXFirst>(px, py, GlobalTaps{win, src.stride()});
}

// The same value with no branch around the taps: a sample that is not
// taken (`take` false, or rejected by the test) reads the window's first
// four taps instead and drops them.  In an unrolled loop over a thread's
// samples the loads of all of them are then started before any is used;
// behind `sample`'s branch each sample's loads waited for the one before.
// The window must be at least 2x2.
template <class Src>
__device__ __forceinline__ float sample_unbranched(const Src& src, const float* win,
                                                   bool take, float px, float py,
                                                   float ox, float oy, float lw,
                                                   float lh) {
  const bool in = take && admitted(px, py, ox, oy, lw, lh, (float)src.WX - 1.0f,
                                   (float)src.WY - 1.0f);
  const float v = bilinear<Src::kXFirst>(in ? px : 0.0f, in ? py : 0.0f,
                                         GlobalTaps{win, src.stride()});
  return in ? v : 0.0f;
}

// ---------------------------------------------------------------------------
// Resample, wide patches: one thread per output sample, grid (keypoint,
// sample tile), taps from global memory.
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
// Resample: one block per keypoint, the patch's box staged in shared memory.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Zero o[0, count) with streaming stores, 16 bytes wide over the aligned
// middle (a keypoint's patch starts on no 16-byte line, the array does).
__device__ __forceinline__ void zero_fill(float* o, int count, int t, int T) {
  int head = (int)(((16u - (unsigned)((uintptr_t)o & 15u)) & 15u) >> 2);
  if (head > count) head = count;
  const int nv = (count - head) >> 2;
  const int tail = head + (nv << 2);
  if (t < head) __stcs(o + t, 0.0f);
  float4* v = reinterpret_cast<float4*>(o + head);
  for (int q = t; q < nv; q += T) __stcs(v + q, make_float4(0.0f, 0.0f, 0.0f, 0.0f));
  if (t < count - tail) __stcs(o + tail + t, 0.0f);
}

// One keypoint's row of params, and its window: the first element and the
// column of the source's row that holds it.
struct Key {
  float cxl, cyl, a00, a01, a10, a11, ox, oy, lw, lh;
  bool live;
  const float* win;
  int oxi;
};

template <class Src>
__device__ __forceinline__ Key load_key(const Src& src,
                                        const float* __restrict__ params,
                                        int ncols, int live_col, int k) {
  const float* pr = params + (size_t)k * ncols;
  Key r;
  r.cxl = __ldg(pr + 0); r.cyl = __ldg(pr + 1);
  r.a00 = __ldg(pr + 2); r.a01 = __ldg(pr + 3);
  r.a10 = __ldg(pr + 4); r.a11 = __ldg(pr + 5);
  r.ox = __ldg(pr + 6); r.oy = __ldg(pr + 7);
  r.lw = __ldg(pr + 8); r.lh = __ldg(pr + 9);
  r.live = live_col < 0 || __ldg(pr + live_col) > 0.5f;
  src.locate(k, r.win, r.oxi);
  return r;
}

// Least and greatest sample position of one axis over the patch,
// p = c0 + ig*a + jg*b with ig, jg in [lo, hi]: each rounded operation is
// monotone in ig and in jg, so the four corners bound every sample exactly.
// NaNs drop out of fminf/fmaxf; an all-NaN axis comes back as (NaN, NaN).
__device__ __forceinline__ void corner_range(float c0, float a, float b, float lo,
                                             float hi, float& pmin, float& pmax) {
  const float p0 = c0 + lo * a + lo * b;
  const float p1 = c0 + hi * a + lo * b;
  const float p2 = c0 + lo * a + hi * b;
  const float p3 = c0 + hi * a + hi * b;
  pmin = fminf(fminf(p0, p1), fminf(p2, p3));
  pmax = fmaxf(fmaxf(p0, p1), fmaxf(p2, p3));
}

// t / d for 0 <= t <= 512 and 1 <= d <= 512 without a division:
// (t * magic(d)) >> 20, magic(d) = ceil(2^20 / d).
__host__ __device__ __forceinline__ int div_magic(int d) {
  return ((1 << 20) + d - 1) / d;
}
__device__ __forceinline__ int div_by(int t, int magic) { return (t * magic) >> 20; }

// What a block does with one keypoint.
enum PlanMode { kZero, kStaged, kDirect };
struct Plan {
  int mode;       // kZero: dead row, or no sample can be admitted
  int all_in;     // every sample passes the test: the loop leaves it out
  int xlo, ylo;   // window position of the box's first element
  int pitch, nr;  // box width (a multiple of 4 when copied 16 bytes wide), rows
  int nq, nq_magic, rows_at_once;  // copies a row, and how threads share them
};

// Decided once per keypoint (by one warp; the block reads it from shared
// memory): the box, whether it is staged, and how the threads copy it.
template <int T, class Src>
__device__ __forceinline__ Plan plan_key(const Src& src, const Key& r, int P,
                                         int stage_floats, int vec_ok) {
  Plan p;
  p.mode = kZero;
  p.all_in = 0;
  p.xlo = p.ylo = p.pitch = p.nr = p.nq = p.nq_magic = p.rows_at_once = 0;
  if (!r.live) return p;
  const float c = (float)(P / 2);
  const float wxm1 = (float)src.WX - 1.0f;
  const float wym1 = (float)src.WY - 1.0f;
  // the window-local box [xlo, xhi] x [ylo, yhi] that holds every tap of
  // every admitted sample (floor(p) and floor(p) + 1, with 0 <= p < W - 1)
  const float lo = -c, hi = (float)(P - 1) - c;
  float xmin, xmax, ymin, ymax;
  corner_range(r.cxl, r.a00, r.a01, lo, hi, xmin, xmax);
  corner_range(r.cyl, r.a10, r.a11, lo, hi, ymin, ymax);
  int xlo = (int)fminf(fmaxf(floorf(xmin), 0.0f), wxm1 + 1.0f);
  int xhi = (int)fmaxf(fminf(floorf(xmax) + 1.0f, wxm1), -1.0f);
  const int ylo = (int)fminf(fmaxf(floorf(ymin), 0.0f), wym1 + 1.0f);
  const int yhi = (int)fmaxf(fminf(floorf(ymax) + 1.0f, wym1), -1.0f);
  if (xhi < xlo || yhi < ylo) return p;  // the patch misses its window
  if (vec_ok) {  // widen to 16-byte lines of the source (row % 4 == 0, base aligned)
    xlo -= (r.oxi + xlo) & 3;
    xhi += (4 - ((r.oxi + xhi + 1) & 3)) & 3;
  }
  p.xlo = xlo;
  p.ylo = ylo;
  p.pitch = xhi - xlo + 1;
  p.nr = yhi - ylo + 1;
  p.nq = vec_ok ? p.pitch >> 2 : p.pitch;
  if (p.pitch * p.nr <= stage_floats && p.nq <= T) {
    p.mode = kStaged;
    p.nq_magic = div_magic(p.nq);
    p.rows_at_once = T / p.nq;
  } else {
    p.mode = kDirect;
  }
  // the test is monotone in px and in py (NaNs fail it), so it holds for
  // every sample when it holds at both extremes
  p.all_in = admitted(xmin, ymin, r.ox, r.oy, r.lw, r.lh, wxm1, wym1) &&
             admitted(xmax, ymax, r.ox, r.oy, r.lw, r.lh, wxm1, wym1);
  return p;
}

// Start the copies of the plan's box into `tile`: thread t takes copy
// t % nq of rows t / nq, t / nq + rows_at_once, ...; 16 bytes each when
// the box was widened to 16-byte lines, else 4 bytes each.
__device__ __forceinline__ void stage_box(const Plan& p, const float* win, int W,
                                          int vec_ok, float* tile, int t) {
  const int r0 = div_by(t, p.nq_magic);
  if (r0 >= p.rows_at_once) return;
  const int at = (t - r0 * p.nq) * (vec_ok ? 4 : 1);
  const float* g = win + (ptrdiff_t)(p.ylo + r0) * W + (p.xlo + at);
  float* s = tile + r0 * p.pitch + at;
  const int gstep = p.rows_at_once * W, sstep = p.rows_at_once * p.pitch;
  for (int r = r0; r < p.nr; r += p.rows_at_once, g += gstep, s += sstep) {
    if (vec_ok) {
      cp_async16(s, g);
    } else {
      cp_async4(s, g);
    }
  }
}

// The samples of patch column i, rows g, g + G, ...: position, test
// (left out when the plan found every sample admitted), bilinear from
// `taps`, streaming store.  (cxl + ig * a00) + jg * a01 is the plain
// version's sum in its order; the column's part is hoisted.
template <bool kTest, bool kXFirst, class Taps>
__device__ __forceinline__ void resample_column(const Taps& taps, const Key& r,
                                                int P, int i, int g, int G,
                                                float wxm1, float wym1,
                                                float* __restrict__ o) {
  const float c = (float)(P / 2);
  const float ig = (float)i - c;
  const float tx = r.cxl + ig * r.a00;
  const float ty = r.cyl + ig * r.a10;
  const int step = G * P;
  float* op = o + g * P + i;
  float jg = (float)g - c;  // whole numbers: adding G keeps it exact
  const float Gf = (float)G;
#pragma unroll 2
  for (int j = g; j < P; j += G, jg += Gf, op += step) {
    const float px = tx + jg * r.a01;
    const float py = ty + jg * r.a11;
    float v = 0.0f;
    if (!kTest || admitted(px, py, r.ox, r.oy, r.lw, r.lh, wxm1, wym1)) {
      v = bilinear<kXFirst>(px, py, taps);
    }
    __stcs(op, v);
  }
}

template <class Src>
__global__ void __launch_bounds__(kResampleThreads)
resample_stage_kernel(Src src, const float* __restrict__ params, int ncols,
                      int live_col, int P, int p_magic, int stage_floats,
                      int vec_ok, float* __restrict__ out) {
  extern __shared__ __align__(16) float tile[];
  __shared__ Key shared_key;
  __shared__ Plan shared_plan;
  constexpr int T = kResampleThreads;
  const int k = blockIdx.x;
  const int t = threadIdx.x;
  // one warp reads the keypoint's row and plans; 8 warps doing the same
  // would issue as many instructions as the sampling itself
  if (t < 32) {
    const Key key = load_key(src, params, ncols, live_col, k);
    const Plan plan = plan_key<T>(src, key, P, stage_floats, vec_ok);
    if (t == 0) {
      shared_key = key;
      shared_plan = plan;
    }
  }
  __syncthreads();
  const Plan pl = shared_plan;
  const int P2 = P * P;
  float* o = out + (size_t)k * P2;
  if (pl.mode == kZero) {  // the same in every thread of the block
    zero_fill(o, P2, t, T);
    return;
  }
  const Key key = shared_key;
  const int G = div_by(T, p_magic);  // row groups; threads beyond G * P idle
  const int g = div_by(t, p_magic);
  const int i = t - g * P;
  const float wxm1 = (float)src.WX - 1.0f;
  const float wym1 = (float)src.WY - 1.0f;
  constexpr bool kXFirst = Src::kXFirst;
  if (pl.mode == kStaged) {
    stage_box(pl, key.win, src.stride(), vec_ok, tile, t);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    if (g >= G) return;
    const TileTaps taps{tile, pl.pitch, -(pl.ylo * pl.pitch + pl.xlo)};
    if (pl.all_in) {
      resample_column<false, kXFirst>(taps, key, P, i, g, G, wxm1, wym1, o);
    } else {
      resample_column<true, kXFirst>(taps, key, P, i, g, G, wxm1, wym1, o);
    }
  } else if (g < G) {  // the box does not fit the buffer: taps from the source
    resample_column<true, kXFirst>(GlobalTaps{key.win, src.stride()}, key, P, i, g,
                                   G, wxm1, wym1, o);
  }
}

// ---------------------------------------------------------------------------
// Baumberg.  params [n, ncols]: cxl cyl ratio valid ox oy lw lh
// ---------------------------------------------------------------------------
// One SMM step from the three masked sums' means (a, b, cc) and the current
// U: the inverse square root of SPD [[a,b],[b,cc]] at det 1 (helpers.cpp:
// 463-502), the new U, its eigenvalues (helpers.cpp:504-515), accept or
// reject.  Every float operation is in the plain version's order.
struct BState {
  float u11, u12, u21, u22;
  float ratio_bef;
  int done, ok;
  float o11, o12, o21, o22;
};

__device__ __forceinline__ void baumberg_init(BState& st, bool valid) {
  st.u11 = 1.0f; st.u12 = 0.0f; st.u21 = 0.0f; st.u22 = 1.0f;
  st.ratio_bef = 0.0f;
  st.done = !valid;
  st.ok = 0;
  st.o11 = 1.0f; st.o12 = 0.0f; st.o21 = 0.0f; st.o22 = 1.0f;
}

__device__ __forceinline__ void baumberg_update(BState& st, float a, float b,
                                                float cc, float conv) {
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

__device__ __forceinline__ void baumberg_store(const BState& st, int k,
                                               float* __restrict__ U,
                                               uint8_t* __restrict__ ok) {
  float* u = U + (size_t)k * 4;
  u[0] = st.o11; u[1] = st.o12; u[2] = st.o21; u[3] = st.o22;
  ok[k] = (uint8_t)st.ok;
}

// Central-difference gradient of the ws x ws patch at (i, j), one-sided on
// the border, and its three masked second-moment products.
__device__ __forceinline__ void smm_products(const float* patch, int ws, int i,
                                             int j, float m, float& p1, float& p2,
                                             float& p3) {
  const int ip = i == ws - 1 ? i : i + 1, im = i == 0 ? i : i - 1;
  const int jp = j == ws - 1 ? j : j + 1, jm = j == 0 ? j : j - 1;
  const float fx = patch[j * ws + ip] - patch[j * ws + im];
  const float fy = patch[jp * ws + i] - patch[jm * ws + i];
  p1 = fx * fx * m;
  p2 = fx * fy * m;
  p3 = fy * fy * m;
}

// kBaumbergWinWarps warps per keypoint, one keypoint a block: a thread
// holds ws*ws / threads samples, the warps' sums meet in shared memory and
// every thread runs the 2x2 update.  WS as in baumberg_warp_kernel below.
template <class Src, int WS>
__global__ void __launch_bounds__(32 * kBaumbergWinWarps)
baumberg_block_kernel(Src src, const float* __restrict__ params, int ncols,
                      const float* __restrict__ mask, int ws_rt, int max_iter,
                      float conv, float* __restrict__ U,
                      uint8_t* __restrict__ ok) {
  extern __shared__ float patch[];  // ws*ws
  __shared__ float red[kBaumbergWinWarps][3];
  constexpr int T = 32 * kBaumbergWinWarps;
  // samples of a thread in flight together: all of them when WS is known
  constexpr int kUnroll = WS ? (WS * WS + T - 1) / T : 4;
  const int ws = WS ? WS : ws_rt;
  const int ws2 = ws * ws;
  const int nq = (ws2 + T - 1) / T;  // samples of a thread
  const int t = threadIdx.x;
  const int lane = t & 31, w = t >> 5;
  const int k = blockIdx.x;
  const float* pr = params + (size_t)k * ncols;
  const float cxl = pr[0], cyl = pr[1], ratio = pr[2];
  const float ox = pr[4], oy = pr[5], lw = pr[6], lh = pr[7];
  BState st;
  baumberg_init(st, pr[3] > 0.5f);  // an invalid keypoint never enters the loop
  const float* win = src.base(k);
  const float c = (float)(ws / 2);
  const float n_mask = (float)ws2;
  // a thread's mask weights stay in registers when their number is known
  float m[kUnroll];
#pragma unroll
  for (int q = 0; q < kUnroll; ++q) {
    const int s = t + T * q;
    m[q] = (WS && s < ws2) ? __ldg(mask + s) : 0.0f;
  }

  for (int it = 0; it < max_iter; ++it) {
    // every thread computed the same state from the same numbers, so the
    // block leaves together and no barrier below is skipped by a part of it
    if (st.done) break;
    const float a00 = st.u11 * ratio, a01 = st.u12 * ratio;
    const float a10 = st.u21 * ratio, a11 = st.u22 * ratio;
#pragma unroll kUnroll
    for (int q = 0; q < nq; ++q) {
      const int s = t + T * q;
      const float ig = (float)(s % ws) - c, jg = (float)(s / ws) - c;
      const float px = cxl + ig * a00 + jg * a01;
      const float py = cyl + ig * a10 + jg * a11;
      const float v = sample_unbranched(src, win, s < ws2, px, py, ox, oy, lw, lh);
      if (s < ws2) patch[s] = v;
    }
    __syncthreads();  // the patch is complete
    float s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll kUnroll
    for (int q = 0; q < nq; ++q) {
      const int s = t + T * q;
      if (s < ws2) {
        float p1, p2, p3;
        smm_products(patch, ws, s % ws, s / ws, WS ? m[q] : __ldg(mask + s), p1, p2,
                     p3);
        s1 += p1;
        s2 += p2;
        s3 += p3;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {  // every lane ends with the same bits
      s1 += __shfl_xor_sync(kFullWarp, s1, off);
      s2 += __shfl_xor_sync(kFullWarp, s2, off);
      s3 += __shfl_xor_sync(kFullWarp, s3, off);
    }
    if (lane == 0) { red[w][0] = s1; red[w][1] = s2; red[w][2] = s3; }
    // the warps' totals are complete; the patch has been read out, so the
    // next iteration may fill it again without a further barrier
    __syncthreads();
    float a = 0.0f, b = 0.0f, cc = 0.0f;
#pragma unroll
    for (int v = 0; v < kBaumbergWinWarps; ++v) {
      a += red[v][0];
      b += red[v][1];
      cc += red[v][2];
    }
    baumberg_update(st, a / n_mask, b / n_mask, cc / n_mask, conv);
  }
  if (t == 0) baumberg_store(st, k, U, ok);
}

// One warp per keypoint, kBaumbergWarps keypoints a block.  WS is the patch
// width when it is known at compile time (the loops over a lane's samples
// unroll, their taps overlap, and each sample's patch coordinates and mask
// weight stay in registers), 0 to take it from `ws_rt`.
template <class Src, int WS>
__global__ void __launch_bounds__(32 * kBaumbergWarps)
baumberg_warp_kernel(Src src, const float* __restrict__ params, int ncols,
                     const float* __restrict__ mask, int ws_rt, int max_iter,
                     float conv, int n, float* __restrict__ U,
                     uint8_t* __restrict__ ok) {
  extern __shared__ float slabs[];  // kBaumbergWarps x ws*ws
  constexpr int kUnroll = kBaumbergUnroll;  // samples of a lane in flight together
  const int ws = WS ? WS : ws_rt;
  const int ws2 = ws * ws;
  const int nq = (ws2 + 31) >> 5;  // samples of a lane
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int k = blockIdx.x * kBaumbergWarps + w;
  if (k >= n) return;  // a whole warp; the kernel has no block-wide barrier
  float* patch = slabs + w * ws2;
  const float* pr = params + (size_t)k * ncols;
  const float cxl = pr[0], cyl = pr[1], ratio = pr[2];
  const float ox = pr[4], oy = pr[5], lw = pr[6], lh = pr[7];
  BState st;
  baumberg_init(st, pr[3] > 0.5f);
  const float* win = src.base(k);
  const float c = (float)(ws / 2);
  const float n_mask = (float)ws2;

  for (int it = 0; it < max_iter; ++it) {
    // every lane holds the same state; the vote states it to the compiler
    if (__any_sync(kFullWarp, st.done)) break;
    const float a00 = st.u11 * ratio, a01 = st.u12 * ratio;
    const float a10 = st.u21 * ratio, a11 = st.u22 * ratio;
#pragma unroll kUnroll
    for (int q = 0; q < nq; ++q) {
      const int s = lane + 32 * q;
      const float ig = (float)(s % ws) - c, jg = (float)(s / ws) - c;
      const float px = cxl + ig * a00 + jg * a01;
      const float py = cyl + ig * a10 + jg * a11;
      const float v = sample_unbranched(src, win, s < ws2, px, py, ox, oy, lw, lh);
      if (s < ws2) patch[s] = v;
    }
    __syncwarp();
    float s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll kUnroll
    for (int q = 0; q < nq; ++q) {
      const int s = lane + 32 * q;
      if (s < ws2) {
        float p1, p2, p3;
        smm_products(patch, ws, s % ws, s / ws, __ldg(mask + s), p1, p2, p3);
        s1 += p1;
        s2 += p2;
        s3 += p3;
      }
    }
    // butterfly: both lanes of a pair add the same two numbers, so every
    // lane ends with the same bits
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(kFullWarp, s1, off);
      s2 += __shfl_xor_sync(kFullWarp, s2, off);
      s3 += __shfl_xor_sync(kFullWarp, s3, off);
    }
    baumberg_update(st, s1 / n_mask, s2 / n_mask, s3 / n_mask, conv);
    __syncwarp();  // the slab is read out before the next iteration fills it
  }
  if (lane == 0) baumberg_store(st, k, U, ok);
}

// ---------------------------------------------------------------------------
// Launches, shared by the stack and the window entries
// ---------------------------------------------------------------------------
// The wide-patch path: a patch wider than a block has threads for its
// columns.
template <class Src>
int launch_resample_wide(const Src& src, const float* params, int ncols,
                       int live_col, int n, int P, float* out,
                       cudaStream_t stream) {
  const int threads = 128;
  dim3 grid(n, (P * P + threads - 1) / threads);
  resample_kernel<Src><<<grid, threads, 0, stream>>>(src, params, ncols,
                                                     live_col, P, out);
  return (int)cudaGetLastError();
}

// stage_floats: the staging buffer of a block, in floats (0: every
// keypoint takes its taps from global memory); vec_ok: whether the source
// allows 16-byte copies.  A patch wider than the block has threads for its
// columns takes the wide-patch path.
template <class Src>
int launch_resample(const Src& src, const float* params, int ncols, int live_col,
                    int n, int P, int stage_floats, int vec_ok, float* out,
                    cudaStream_t stream) {
  if (stage_floats < 0) return (int)cudaErrorInvalidValue;
  if (P > kResampleThreads) {
    return launch_resample_wide(src, params, ncols, live_col, n, P, out, stream);
  }
  const size_t smem = (size_t)stage_floats * sizeof(float);
  if (smem + 1024 > 48 * 1024) {  // with the kernel's static shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        resample_stage_kernel<Src>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  resample_stage_kernel<Src><<<n, kResampleThreads, smem, stream>>>(
      src, params, ncols, live_col, P, div_magic(P), stage_floats, vec_ok, out);
  return (int)cudaGetLastError();
}

// One warp per keypoint.
template <class Src>
int launch_baumberg_warp(const Src& src, const float* params, int ncols,
                         const float* mask, int ws, int max_iter, float conv,
                         int n, float* U, uint8_t* ok, cudaStream_t stream) {
  const int blocks = (n + kBaumbergWarps - 1) / kBaumbergWarps;
  const int threads = 32 * kBaumbergWarps;
  const size_t smem = (size_t)kBaumbergWarps * ws * ws * sizeof(float);
  if (ws == 19) {  // Config's smmWindowSize
    baumberg_warp_kernel<Src, 19><<<blocks, threads, smem, stream>>>(
        src, params, ncols, mask, ws, max_iter, conv, n, U, ok);
  } else {
    baumberg_warp_kernel<Src, 0><<<blocks, threads, smem, stream>>>(
        src, params, ncols, mask, ws, max_iter, conv, n, U, ok);
  }
  return (int)cudaGetLastError();
}

// kBaumbergWinWarps warps per keypoint.
template <class Src>
int launch_baumberg_block(const Src& src, const float* params, int ncols,
                          const float* mask, int ws, int max_iter, float conv,
                          int n, float* U, uint8_t* ok, cudaStream_t stream) {
  const int threads = 32 * kBaumbergWinWarps;
  const size_t smem = (size_t)ws * ws * sizeof(float);
  if (ws == 19) {
    baumberg_block_kernel<Src, 19><<<n, threads, smem, stream>>>(
        src, params, ncols, mask, ws, max_iter, conv, U, ok);
  } else {
    baumberg_block_kernel<Src, 0><<<n, threads, smem, stream>>>(
        src, params, ncols, mask, ws, max_iter, conv, U, ok);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Octave extrema: NMS, compaction, localization and the duplicate map
// ---------------------------------------------------------------------------
constexpr int kExtThreads = 256;             // threads of a tile's block
constexpr int kExtTile = 4 * kExtThreads;    // cells of a tile (32 words)
constexpr int kExtScanThreads = 1024;
constexpr int kExtLocThreads = 128;
constexpr int kExtMaxLevels = 32;

struct ExtremaArgs {
  const float* resp;                 // [L,H,W]
  int L, H, W, border;
  float pos_th;                      // float(0.8 * threshold) under FixedTh, else 0
  float neg_th;                      // float(-pos_th)
  float edge_th;                     // float((r + 1)^2 / r)
  float final_th;                    // localize's final threshold, as a float
  float inv_scales;                  // 1.0f / numberOfScales, rounded as ATen does
  float sigma[kExtMaxLevels];        // the levels' sigmas, as float32
};

// Whether flat cell `cell` of the middle levels [1, L-1) x H x W is a 3x3x3
// extremum inside the border (find_extrema).
__device__ __forceinline__ bool is_extremum(const ExtremaArgs& a, int cell) {
  const int hw = a.H * a.W;
  const int m = cell / hw;
  const int rem = cell - m * hw;
  const int r = rem / a.W;
  const int c = rem - r * a.W;
  if (r < a.border || r >= a.H - a.border || c < a.border || c >= a.W - a.border) {
    return false;
  }
  const float* lev = a.resp + (size_t)(m + 1) * hw;
  const float v = __ldg(lev + r * a.W + c);
  const bool hi = v > a.pos_th;
  const bool lo = v < a.neg_th;
  if (!hi && !lo) return false;
  // the shifts of _maxpool3 wrap around like torch.roll
  const int rows[3] = {r == 0 ? a.H - 1 : r - 1, r, r == a.H - 1 ? 0 : r + 1};
  const int cols[3] = {c == 0 ? a.W - 1 : c - 1, c, c == a.W - 1 ? 0 : c + 1};
  bool ge = true, le = true;   // false at any NaN among the 27
#pragma unroll
  for (int dl = -1; dl <= 1; ++dl) {
    const float* p = lev + (ptrdiff_t)dl * hw;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float u = __ldg(p + rows[i] * a.W + cols[j]);
        ge = ge && (v >= u);
        le = le && (v <= u);
      }
    }
  }
  return (hi && ge) || (lo && le);
}

__global__ void __launch_bounds__(kExtThreads)
extrema_mark_kernel(ExtremaArgs a, int n, uint32_t* __restrict__ words,
                    int* __restrict__ tile_counts, int* __restrict__ cell_map) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int base = blockIdx.x * kExtTile;
  int count = 0;
#pragma unroll
  for (int j = 0; j < kExtTile / kExtThreads; ++j) {
    const int first = base + j * kExtThreads + warp * 32;   // the warp's word
    const int cell = first + lane;
    const uint32_t bits = __ballot_sync(kFullWarp, cell < n && is_extremum(a, cell));
    if (lane == 0 && first < n) words[first >> 5] = bits;
    count += __popc(bits);
  }
  __shared__ int warp_counts[kExtThreads / 32];
  if (lane == 0) warp_counts[warp] = count;
  const int hw = a.H * a.W;
  for (int i = blockIdx.x * kExtThreads + threadIdx.x; i < hw;
       i += gridDim.x * kExtThreads) {
    cell_map[i] = INT_MAX;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kExtThreads / 32; ++w) total += warp_counts[w];
    tile_counts[blockIdx.x] = total;
  }
}

// One block: tile counts -> exclusive offsets in place; n_out = the total.
__global__ void __launch_bounds__(kExtScanThreads)
extrema_scan_kernel(int* __restrict__ tiles, int n_tiles, int* __restrict__ n_out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per = (n_tiles + kExtScanThreads - 1) / kExtScanThreads;
  const int lo = min(threadIdx.x * per, n_tiles);
  const int hi = min(lo + per, n_tiles);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += tiles[i];
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(kFullWarp, incl, off);
    if (lane >= off) incl += t;
  }
  __shared__ int warp_incl[kExtScanThreads / 32];
  if (lane == 31) warp_incl[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_incl[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFullWarp, w, off);
      if (lane >= off) w += t;
    }
    warp_incl[lane] = w;
  }
  __syncthreads();
  int run = incl - sum + (warp > 0 ? warp_incl[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int v = tiles[i];
    tiles[i] = run;
    run += v;
  }
  if (threadIdx.x == kExtScanThreads - 1) *n_out = run;
}

__global__ void __launch_bounds__(kExtThreads)
extrema_scatter_kernel(const uint32_t* __restrict__ words,
                       const int* __restrict__ tile_offsets, int n, int k,
                       int* __restrict__ idx) {
  const int offset = tile_offsets[blockIdx.x];
  if (offset >= k) return;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __shared__ uint32_t tile_words[32];
  __shared__ int word_prefix[32];
  if (warp == 0) {
    const int w = blockIdx.x * 32 + lane;
    const uint32_t bits = w < (n + 31) / 32 ? words[w] : 0u;
    const int pop = __popc(bits);
    int incl = pop;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFullWarp, incl, off);
      if (lane >= off) incl += t;
    }
    tile_words[lane] = bits;
    word_prefix[lane] = incl - pop;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kExtTile / kExtThreads; ++j) {
    const int wl = j * (kExtThreads / 32) + warp;   // the warp's word in the tile
    const uint32_t bits = tile_words[wl];
    if ((bits >> lane) & 1u) {
      const int pos = offset + word_prefix[wl] + __popc(bits & ((1u << lane) - 1u));
      if (pos < k) idx[pos] = blockIdx.x * kExtTile + wl * 32 + lane;
    }
  }
}

__global__ void __launch_bounds__(kExtLocThreads)
extrema_localize_kernel(ExtremaArgs a, const int* __restrict__ idx,
                        const int* __restrict__ n_ext, int k,
                        float* __restrict__ rc, int* __restrict__ level,
                        float* __restrict__ scale, float* __restrict__ response,
                        uint8_t* __restrict__ valid, int* __restrict__ r_out,
                        int* __restrict__ c_out, int* __restrict__ cell_map) {
  const int i = blockIdx.x * kExtLocThreads + threadIdx.x;
  if (i >= k) return;
  const int H = a.H, W = a.W;
  const int hw = H * W;
  const bool cand = i < min(k, *n_ext);
  const int id = cand ? idx[i] : 0;
  const int lev = id / hw + 1;
  int r = (id % hw) / W;
  int c = id % W;
  const long long base = (long long)lev * hw;
  const long long last = (long long)a.L * hw - 1;
  float bx = 0.0f, by = 0.0f, bs = 0.0f, val = 0.0f;
  bool alive = cand, rejected = !cand;
  for (int it = 0; it < 5 && alive; ++it) {
    // (a row no longer alive is not updated again: leaving is exact)
    const long long lin = base + (long long)r * W + c;
    float cu[27];
#pragma unroll
    for (int q = 0; q < 27; ++q) {
      const long long off = (long long)(q / 9 - 1) * hw + (q / 3 % 3 - 1) * W + (q % 3 - 1);
      const long long j = min(max(lin + off, 0ll), last);
      cu[q] = __ldg(a.resp + j);
    }
#define CUR(dr, dc) cu[9 + ((dr) + 1) * 3 + ((dc) + 1)]
#define LOW(dr, dc) cu[((dr) + 1) * 3 + ((dc) + 1)]
#define HIGH(dr, dc) cu[18 + ((dr) + 1) * 3 + ((dc) + 1)]
    const float c11 = CUR(0, 0);
    const float dxx = (CUR(0, -1) - 2.0f * c11) + CUR(0, 1);
    const float dyy = (CUR(-1, 0) - 2.0f * c11) + CUR(1, 0);
    const float dss = (LOW(0, 0) - 2.0f * c11) + HIGH(0, 0);
    const float dxy = 0.25f * (((CUR(1, 1) - CUR(1, -1)) - CUR(-1, 1)) + CUR(-1, -1));
    const float dxs = 0.25f * (((HIGH(0, 1) - HIGH(0, -1)) - LOW(0, 1)) + LOW(0, -1));
    const float dys = 0.25f * (((HIGH(1, 0) - HIGH(-1, 0)) - LOW(1, 0)) + LOW(-1, 0));
    const float dx = 0.5f * (CUR(0, 1) - CUR(0, -1));
    const float dy = 0.5f * (CUR(1, 0) - CUR(-1, 0));
    const float ds = 0.5f * (HIGH(0, 0) - LOW(0, 0));
#undef CUR
#undef LOW
#undef HIGH
    bool edge_bad = false;
    if (it == 0) {
      const float tr = dxx + dyy;
      const float edge_score = (tr * tr) / (dxx * dyy - dxy * dxy);
      edge_bad = (edge_score >= a.edge_th) || (edge_score < 0.0f);
    }
    const float det = (dxx * (dyy * dss - dys * dys) - dxy * (dxy * dss - dys * dxs))
                      + dxs * (dxy * dys - dyy * dxs);
    const float nbx = -((dx * (dyy * dss - dys * dys) - dxy * (dy * dss - dys * ds))
                        + dxs * (dy * dys - dyy * ds)) / det;
    const float nby = -((dxx * (dy * dss - dys * ds) - dx * (dxy * dss - dxs * dys))
                        + dxs * (dxy * ds - dxs * dy)) / det;
    const float nbs = -((dxx * (dyy * ds - dy * dys) - dxy * (dxy * ds - dy * dxs))
                        + dx * (dxy * dys - dyy * dxs)) / det;
    const bool nan_bad = !(isfinite(nbx) && isfinite(nby) && isfinite(nbs));
    const float val_new = c11 + 0.5f * ((dx * nbx + dy * nby) + ds * nbs);
    const bool move_px = nbx > 0.6f, move_mx = nbx < -0.6f;
    const bool move_py = nby > 0.6f, move_my = nby < -0.6f;
    const bool oob = (move_px && c >= W - 3) || (move_mx && c <= 3) ||
                     (move_py && r >= H - 3) || (move_my && r <= 3);
    const int nc = c + (int)move_px - (int)move_mx;
    const int nr = r + (int)move_py - (int)move_my;
    const bool converged = nr == r && nc == c;
    if (edge_bad || nan_bad || oob) {
      rejected = true;
      alive = false;
    } else {
      r = nr;
      c = nc;
      bx = nbx;
      by = nby;
      bs = nbs;
      val = val_new;
      alive = !converged;
    }
  }
  const bool ok = !rejected && fabsf(bx) <= 1.5f && fabsf(by) <= 1.5f &&
                  fabsf(bs) <= 1.5f && fabsf(val) >= a.final_th;
  rc[2 * i] = (float)r + by;
  rc[2 * i + 1] = (float)c + bx;
  level[i] = lev;
  scale[i] = a.sigma[lev] * exp2f(bs * a.inv_scales);
  response[i] = val;
  valid[i] = ok;
  r_out[i] = r;
  c_out[i] = c;
  if (ok) atomicMin(cell_map + r * W + c, i);
}

__global__ void __launch_bounds__(kExtLocThreads)
extrema_keep_kernel(const int* __restrict__ r, const int* __restrict__ c,
                    const uint8_t* __restrict__ valid,
                    const int* __restrict__ cell_map, int W, int k,
                    uint8_t* __restrict__ kept) {
  const int i = blockIdx.x * kExtLocThreads + threadIdx.x;
  if (i >= k) return;
  kept[i] = valid[i] && cell_map[r[i] * W + c[i]] == i;
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (bound with ctypes)
// ---------------------------------------------------------------------------
extern "C" {

int resample_pyr(const float* stack, int H, int W, const int* lev,
                 const int* oy, const int* ox, const float* params, int ncols,
                 int live_col, int n, int P, int WY, int WX, int stage_floats,
                 float* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  PyrSrc src{stack, H, W, lev, oy, ox, WY, WX};
  const int vec_ok = (W % 4 == 0) && ((uintptr_t)stack % 16 == 0);
  return launch_resample(src, params, ncols, live_col, n, P, stage_floats, vec_ok,
                         out, (cudaStream_t)stream);
}

// Windows have no live column.  With Wn a multiple of 4 every window of an
// array that starts on a 16-byte line does too.
int resample_win(const float* wins, int Wn, const float* params,
                 int ncols, int n, int P, int stage_floats, float* out,
                 void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  WinSrc src{wins, Wn, Wn, Wn};
  const int vec_ok = (Wn % 4 == 0) && ((uintptr_t)wins % 16 == 0);
  return launch_resample(src, params, ncols, -1, n, P, stage_floats, vec_ok, out,
                         (cudaStream_t)stream);
}

int baumberg_pyr(const float* stack, int H, int W, const int* lev,
                 const int* oy, const int* ox, const float* params, int ncols,
                 const float* mask, int ws, int max_iter, float conv, int n,
                 int WY, int WX, float* U, uint8_t* ok, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  PyrSrc src{stack, H, W, lev, oy, ox, WY, WX};
  return launch_baumberg_warp(src, params, ncols, mask, ws, max_iter, conv, n, U,
                              ok, (cudaStream_t)stream);
}

// Baumberg on windows: a few warps per keypoint.
int baumberg_win(const float* wins, int Wn, const float* params,
                 int ncols, const float* mask, int ws, int max_iter, float conv,
                 int n, float* U, uint8_t* ok, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  WinSrc src{wins, Wn, Wn, Wn};
  return launch_baumberg_block(src, params, ncols, mask, ws, max_iter, conv, n, U,
                               ok, (cudaStream_t)stream);
}

// One octave's extrema search, localization and duplicate map: five
// launches on `stream`.  resp [L,H,W] float32; sigmas [L] on the host;
// k = min(max_cands, (L-2)*H*W) candidate slots.  Scratch: words
// [ceil(N/32)], tiles [ceil(N/kExtTile)], n_ext [1], idx [k], cell_map
// [H*W] (N = (L-2)*H*W).  Outputs [k]: rc [k,2], level, scale, response,
// valid (localize's), r, c (final cells), kept (valid after the map).
int octave_extrema(const float* resp, int L, int H, int W, int border,
                   float pos_th, float edge_th, float final_th,
                   float inv_scales, const float* sigmas, int k,
                   uint32_t* words, int* tiles, int* n_ext, int* idx,
                   int* cell_map, float* rc, int* level, float* scale,
                   float* response, uint8_t* valid, int* r, int* c,
                   uint8_t* kept, void* stream) {
  if (L < 3 || L > kExtMaxLevels || H < 1 || W < 1 || k < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n_ll = (long long)(L - 2) * H * W;
  if ((long long)L * H * W > INT_MAX - kExtTile || k > n_ll) {
    return (int)cudaErrorInvalidValue;
  }
  const int n = (int)n_ll;
  ExtremaArgs a;
  a.resp = resp;
  a.L = L;
  a.H = H;
  a.W = W;
  a.border = border;
  a.pos_th = pos_th;
  a.neg_th = -pos_th;
  a.edge_th = edge_th;
  a.final_th = final_th;
  a.inv_scales = inv_scales;
  for (int l = 0; l < kExtMaxLevels; ++l) a.sigma[l] = l < L ? sigmas[l] : 0.0f;
  const cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = (n + kExtTile - 1) / kExtTile;
  const int slot_blocks = (k + kExtLocThreads - 1) / kExtLocThreads;
  extrema_mark_kernel<<<n_tiles, kExtThreads, 0, st>>>(a, n, words, tiles, cell_map);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  extrema_scan_kernel<<<1, kExtScanThreads, 0, st>>>(tiles, n_tiles, n_ext);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  extrema_scatter_kernel<<<n_tiles, kExtThreads, 0, st>>>(words, tiles, n, k, idx);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  extrema_localize_kernel<<<slot_blocks, kExtLocThreads, 0, st>>>(
      a, idx, n_ext, k, rc, level, scale, response, valid, r, c, cell_map);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  extrema_keep_kernel<<<slot_blocks, kExtLocThreads, 0, st>>>(r, c, valid, cell_map,
                                                              W, k, kept);
  return (int)cudaGetLastError();
}

}  // extern "C"
