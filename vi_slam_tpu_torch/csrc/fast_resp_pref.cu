// FAST-9 response, 3x3 NMS, high-threshold preference and the per-cell
// winner, for every level of one image pyramid in one launch, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel `vi_slam_tpu/ops/fast_pallas.py::fast_resp_pref`
// (pl.pallas_call at :174, body `_strip_kernel` :46-136), and runs in its
// epilogue what the JAX package then does outside it, `ops/fast.py::
// cell_max`. Its plain PyTorch version is `vi_slam_tpu_torch/ops/
// fast_kernel.py::pyramid_resp_cells_plain` (`ops/fast.py::resp_pref` and
// `cell_max` per level); the two agree bit for bit, because every arc sum
// is taken in the same order and the cell winner is the same argmax.
//
// What it computes, for each (H, W) float32 level:
//   resp(p)  = max over the 9-arcs of the 16-pixel Bresenham circle that
//              are all brighter (or all darker) than p by more than th_lo,
//              of the threshold excess summed along the arc; 0 when there
//              is no such arc or p lies within 3 px of the level's border.
//   keep(p)  = resp(p) > 0 and resp(p) >= resp of all 8 neighbours
//              (neighbours outside the level do not count).
//   map(p)   = keep ? resp(p) (+ 1e4 if p also has a 9-arc at th_hi) : 0.
//   cell c   = (score, x, y) of the largest map value in the cell x cell
//              square c, the first in row-major order on a tie (the rule of
//              torch.argmax), so a cell of zeros gives its origin and 0;
//              pixels of a border cell outside the level count as 0.
//
// Design. A work list of tiles covers every level: tile side = cell size,
// tiles aligned to each level's cell grid, so tile i of level l is cell i
// of level l and block b runs tile b. The levels come by value in the
// kernel parameters (at most 16), each with its first tile; one thread
// finds the block's level by scanning those offsets. A block stages its
// tile and a 4 px halo (3 for the circle, 1 for the NMS ring) of the input
// in shared memory with coalesced loads, zero-filled outside the level:
// only pixels within 3 px of the border read the halo outside the level,
// and their response is forced to 0. Then, per warp:
//   a. the arc masks of its pixels of the tile and its ring (one pixel
//      per lane per round); the pixels with a 9-arc go to a warp queue
//      (ballot and prefix popcount);
//   b. the arc sums of the queued pixels, one pixel per lane;
//   c. after a block barrier, NMS of its outputs; the kept ones go to the
//      queue, and their high-threshold test runs one pixel per lane;
//   d. the writes, and the cell's winner by warp shuffles, then shared
//      memory across warps.
// A lane thus works on one pixel at a time in every pass, and the passes
// that only some pixels need (a third of the pixels have an arc, a few
// per cent survive NMS) run dense instead of idling most lanes of a warp.
//
// What it does about the costs of the earlier kernel, one launch per level
// (commit edc5e27, 107 us per 376x1241 pyramid on an H100):
//   1. One launch per level, each at least one block's latency (levels 4-7
//      had 44-114 blocks for 132 SMs): one launch per pyramid, 1,492 tiles
//      of 32 px for a 376x1241 image.
//   2. 4.5 responses in series per thread, each with both arc sums: the
//      masks one pixel per lane, and only the pixels with an arc sum it
//      (one polarity: 9 + 9 > 16 circle points).
//   3. Host cost per call: one call per pyramid, into one flat map and one
//      flat cell buffer that the caller indexes by level offset; the
//      wrapper looks up the C entry and its argument types once.
//   4. The per-cell winner in about 10 small PyTorch ops per level: here,
//      in the epilogue; only the top-k over the cells stays in PyTorch.
// Blocks of 256 threads, at most 8 on an SM (a 32-register cap): a block
// of 1,024 threads, one output each, holds a whole SM through each of its
// barriers.
// TMA is not used: its tiled copies need 16-byte row pitches, and 7 of
// the 8 level widths (1241, 1034, 862, 718, 598, 499, 346) are not.
//
// Bound on the H100 SXM (3.35 TB/s, 67 TFLOP/s float32): it must read 4 B
// and write 4 B per pixel and 12 B per cell; the 8 levels of a 376x1241
// image (1,444,097 px, 1,492 cells) are 11.57 MB, 3.45 us, and the bytes
// term is the larger. The operations the function needs: per interior
// pixel 16 differences and 32 low-threshold compares, per pixel 9 NMS
// compares and 1 cell compare; per pixel with an arc one polarity's 16
// excesses (subtract and clamp); per valid arc start 8 adds and 1 max;
// per kept pixel the 32 high-threshold compares and the bonus add: 1.47
// us on frame 0 of chip_smoke.py's world, which computes both terms from
// the run's images. The kernel is far from the bound: it is bound by
// instruction issue and by the latency between its barriers.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kHalo = 4;
constexpr int kBorder = 3;
constexpr int kArc = 9;

struct Level {
  const float* in;
  float* map;
  int h, w;
  int tile0;  // first tile (= cell) of this level in the work list
};

struct Pyramid {
  Level lv[kMaxLevels];
  int n;
};

// Offset of circle point k, (dx, dy) clockwise from 12 o'clock, in a
// shared-memory tile whose rows are S floats apart. Folded to a constant
// when k is.
template <int S>
__device__ __forceinline__ int circle_off(int k) {
  constexpr int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  constexpr int dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  return dy[k] * S + dx[k];
}

// Bit j of the result is set iff the 9-arc starting at circle index j is
// all set in the 16-bit mask m (cyclic): runs of 2, 4, 8, then 9 bits.
__device__ __forceinline__ uint32_t arc_runs(uint32_t m) {
  const uint32_t m2 = m | (m << 16);
  uint32_t r = m2 & (m2 >> 1);
  r &= r >> 2;
  r &= r >> 4;
  r &= m2 >> 8;
  return r & 0xFFFFu;
}

// Max over the arc starts set in `run` of the excess (sgn * d - th, sgn
// +1 for bright and -1 for dark, clamped at 0) summed along the arc in the
// order j, j+1, ..., j+8: the plain version's order (its first add, 0 +
// e_j, is e_j). All 16 sums are taken and masked, without a branch, so
// that their chains interleave.
template <int S>
__device__ __forceinline__ float arc_best(const float* p, float c, uint32_t run, float sgn,
                                          float th) {
  float e[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) e[k] = fmaxf(sgn * (p[circle_off<S>(k)] - c) - th, 0.f);
  float best = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float s = e[j];
#pragma unroll
    for (int k = 1; k < kArc; ++k) s += e[(j + k) & 15];
    best = fmaxf(best, ((run >> j) & 1u) ? s : 0.f);
  }
  return best;
}

// The 9-arc runs of brighter (rb) and darker (rd) circle points at
// threshold th >= 0. |d| > th, exactly when th - |d| rounds below 0, marks
// a point of either kind, and the sign of d says which (so exactly d > th
// or d < -th). Each sign bit is shifted in with one funnel shift, from
// point 15 down to point 0, so that point k lands on bit k.
template <int S>
__device__ __forceinline__ void runs(const float* p, float c, float th, uint32_t& rb, uint32_t& rd) {
  uint32_t a = 0, neg = 0;
#pragma unroll
  for (int k = 15; k >= 0; --k) {
    const float d = p[circle_off<S>(k)] - c;
    a = __funnelshift_l(__float_as_uint(th - fabsf(d)), a, 1);
    neg = __funnelshift_l(__float_as_uint(d), neg, 1);
  }
  rb = arc_runs(a & ~neg);
  rd = arc_runs(a & neg);
}

// Keeps the winner of (v, i) and (ov, oi): the larger value, then the
// lower index.
__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    take_better(v, i, __shfl_down_sync(0xFFFFFFFFu, v, o), __shfl_down_sync(0xFFFFFFFFu, i, o));
  }
}

// Appends `item` (0: nothing) of each lane to the warp's queue, in lane
// order, and returns the queue's new length n. Every lane of the warp
// must call it with the same n.
__device__ __forceinline__ int push(uint32_t item, uint32_t* queue, int n) {
  const uint32_t ballot = __ballot_sync(0xFFFFFFFFu, item != 0);
  const uint32_t below = (1u << (threadIdx.x & 31)) - 1u;
  if (item) queue[n + __popc(ballot & below)] = item;
  return n + __popc(ballot);
}

// Threads of a block, and the threads an SM should hold at once (the
// register cap follows: 65,536 / kResident).
constexpr int kThreads = 256;
constexpr int kResident = 2048;

template <int T, int NT>
__global__ void __launch_bounds__(NT, kResident / NT)
fast_pyramid_kernel(const __grid_constant__ Pyramid p, float* __restrict__ cell_score,
                    int* __restrict__ cell_xy, int n_cells, float th_lo, float th_hi) {
  constexpr int kWarps = NT / 32;
  constexpr int kIn = T + 2 * kHalo;  // staged input side
  constexpr int kS = kIn + 1;         // its row pitch in shared memory
  constexpr int kR = T + 2;           // response side: the tile and its NMS ring
  constexpr int kRR = kR * kR;
  constexpr int kOut = T * T / NT;    // outputs per thread
  constexpr int kRounds = (kRR + NT - 1) / NT;
  static_assert(T * T % NT == 0 && NT % 32 == 0 && kRR < (1 << 15), "tile and block shape");
  __shared__ float tile[kIn * kS];
  __shared__ float resp[kRR];
  __shared__ uint32_t queues[kWarps][kRounds * 32];  // a warp's arc pixels, then kept outputs
  __shared__ uint8_t high[T * T];
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ Level s_level;
  __shared__ int s_y0, s_x0;

  // 0. One thread finds the block's level and tile origin for all.
  const int tid = threadIdx.x;
  if (tid == 0) {
    int l = 0;
    for (int i = 1; i < p.n; ++i) l = (int)blockIdx.x >= p.lv[i].tile0 ? i : l;
    const Level lv = p.lv[l];
    const int t = blockIdx.x - lv.tile0;
    const int tiles_x = (lv.w + T - 1) / T;
    s_level = lv;
    s_y0 = (t / tiles_x) * T;
    s_x0 = (t % tiles_x) * T;
  }
  __syncthreads();
  const Level L = s_level;
  const int y0 = s_y0, x0 = s_x0;
  const int lane = tid & 31;
  uint32_t* queue = queues[tid >> 5];

  // 1. Stage the input tile with its halo, zero outside the level.
  for (int i = tid; i < kIn * kIn; i += NT) {
    const int ty = i / kIn, tx = i - ty * kIn;
    const int y = y0 - kHalo + ty, x = x0 - kHalo + tx;
    float v = 0.f;
    if (y >= 0 && y < L.h && x >= 0 && x < L.w) v = __ldg(L.in + (size_t)y * L.w + x);
    tile[ty * kS + tx] = v;
  }
  __syncthreads();

  // 2. Over the tile and its ring (row-major, index i): the arc runs at
  // th_lo. A pixel with a run goes to its warp's queue as (run << 16 |
  // dark << 15 | i); a pixel has bright or dark runs, never both (9 + 9 >
  // 16 circle points). The loop is uniform over the block, so every lane
  // reaches the warp-wide push.
  int n = 0;
  for (int base = 0; base < kRR; base += NT) {
    const int i = base + tid;
    uint32_t item = 0;
    if (i < kRR) {
      const int ry = i / kR, rx = i - ry * kR;
      const int y = y0 - 1 + ry, x = x0 - 1 + rx;
      if (y >= kBorder && y < L.h - kBorder && x >= kBorder && x < L.w - kBorder) {
        const float* q = &tile[(ry + kHalo - 1) * kS + rx + kHalo - 1];
        uint32_t rb, rd;
        runs<kS>(q, q[0], th_lo, rb, rd);
        if (rb) item = rb << 16 | (uint32_t)i;
        else if (rd) item = rd << 16 | 1u << 15 | (uint32_t)i;
      }
      resp[i] = 0.f;
    }
    n = push(item, queue, n);
  }
  __syncwarp();

  // 3. The response of the warp's queued pixels, one per lane at a time,
  // so that no lane idles while its neighbours sum arcs.
  for (int k = lane; k < n; k += 32) {
    const uint32_t item = queue[k];
    const int i = item & 0x7FFF;
    const int ry = i / kR, rx = i - ry * kR;
    const float* q = &tile[(ry + kHalo - 1) * kS + rx + kHalo - 1];
    resp[i] = arc_best<kS>(q, q[0], item >> 16, (item >> 15) & 1u ? -1.f : 1.f, th_lo);
  }
  __syncthreads();

  // 4. NMS on this thread's outputs (o = tid + r * NT); the kept ones go
  // to the warp's queue (free again) for the high-threshold test.
  float v[kOut];
  n = 0;
#pragma unroll
  for (int r = 0; r < kOut; ++r) {
    const int o = tid + r * NT;
    const int ty = o / T, tx = o - (o / T) * T;
    const float c = resp[(ty + 1) * kR + tx + 1];
    bool keep = c > 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) keep = keep && c >= resp[(ty + dy) * kR + tx + dx];
    }
    v[r] = keep ? c : 0.f;
    high[o] = 0;
    n = push(keep ? (uint32_t)o + 1u : 0u, queue, n);
  }
  __syncwarp();

  // 5. The high-threshold 9-arc test of the warp's kept outputs.
  for (int k = lane; k < n; k += 32) {
    const int o = queue[k] - 1;
    const int ty = o / T, tx = o - (o / T) * T;
    const float* q = &tile[(ty + kHalo) * kS + tx + kHalo];
    uint32_t hb, hd;
    runs<kS>(q, q[0], th_hi, hb, hd);
    high[o] = (hb | hd) != 0;
  }
  __syncwarp();

  // 6. The bonus, the writes, and the cell's winner: the best of this
  // thread's outputs (in increasing index, so a tie keeps the first), then
  // of the warp, then of the block.
  float bv = -1.f;
  int bi = 0;
#pragma unroll
  for (int r = 0; r < kOut; ++r) {
    const int o = tid + r * NT;
    const int y = y0 + o / T, x = x0 + (o - (o / T) * T);
    const float val = high[o] ? v[r] + 1e4f : v[r];
    if (y < L.h && x < L.w) L.map[(size_t)y * L.w + x] = val;
    if (val > bv) {
      bv = val;
      bi = o;
    }
  }
  warp_argmax(bv, bi);
  if ((tid & 31) == 0) {
    red_v[tid >> 5] = bv;
    red_i[tid >> 5] = bi;
  }
  __syncthreads();
  if (tid < 32) {
    bv = tid < kWarps ? red_v[tid] : -1.f;
    bi = tid < kWarps ? red_i[tid] : T * T;
    warp_argmax(bv, bi);
    if (tid == 0) {
      cell_score[blockIdx.x] = bv;
      cell_xy[blockIdx.x] = x0 + bi % T;
      cell_xy[n_cells + blockIdx.x] = y0 + bi / T;
    }
  }
}

}  // namespace

// table: n_levels rows of 5 int64 (input pointer, map pointer, h, w, first
// tile); n_cells: the tiles of all levels; cell_score (n_cells,) float32,
// cell_xy (2, n_cells) int32; th_lo, th_hi >= +0.0 (-0.0 is refused: the
// sign-bit test of th - |d| holds for +0.0 and above only). Returns the
// launch's cudaError_t.
extern "C" int fast_pyramid_launch(const int64_t* table, int n_levels, float* cell_score,
                                   int* cell_xy, int n_cells, float th_lo, float th_hi,
                                   int cell, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_cells < 1 || (cell != 16 && cell != 32) ||
      !(th_lo >= 0.f) || !(th_hi >= 0.f) || std::signbit(th_lo) || std::signbit(th_hi)) {
    return (int)cudaErrorInvalidValue;
  }
  Pyramid p = {};
  p.n = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    const int64_t* r = table + 5 * l;
    p.lv[l] = Level{reinterpret_cast<const float*>(r[0]), reinterpret_cast<float*>(r[1]),
                    (int)r[2], (int)r[3], (int)r[4]};
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (cell == 32) {
    fast_pyramid_kernel<32, kThreads>
        <<<n_cells, kThreads, 0, s>>>(p, cell_score, cell_xy, n_cells, th_lo, th_hi);
  } else {
    fast_pyramid_kernel<16, kThreads>
        <<<n_cells, kThreads, 0, s>>>(p, cell_score, cell_xy, n_cells, th_lo, th_hi);
  }
  return (int)cudaGetLastError();
}
