// FAST-9 response + 3x3 NMS + high-threshold preference, one pass, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `vi_slam_tpu/ops/fast_pallas.py::fast_resp_pref`
// (pl.pallas_call at :174, body `_strip_kernel` :46-136). Its plain
// PyTorch version is `vi_slam_tpu_torch/ops/fast.py::resp_pref`; the two
// agree bit for bit, because every arc sum is taken in the same order.
//
// What it computes, for an (H, W) float32 image:
//   resp(p)  = max over the 9-arcs of the 16-pixel Bresenham circle that
//              are all brighter (or all darker) than p by more than th_lo,
//              of the threshold excess summed along the arc; 0 when there
//              is no such arc or p lies within 3 px of the border.
//   keep(p)  = resp(p) > 0 and resp(p) >= resp of all 8 neighbours
//              (neighbours outside the image do not count).
//   out(p)   = keep ? resp(p) (+ 1e4 if p also has a 9-arc at th_hi) : 0.
// Circle samples outside the image are edge-replicated; they only reach
// border pixels, whose response is 0 anyway.
//
// Design. One block writes a 32x32 tile of outputs. It stages the tile
// plus a 4-pixel halo (3 for the circle, 1 for the NMS ring) of the input
// in shared memory, computes the response over the tile and its 1-pixel
// ring (34x34) into shared memory, so that NMS needs no second pass, and
// then applies NMS and the bonus and writes. The TPU kernel's row strips
// and 128-lane padding are not copied: they exist for the TPU's layout.
//
// Bound on the H100 (3.35 TB/s): it must read 4 B and write 4 B per pixel.
// KITTI-00 level 0 (376x1241) is 3.7 MB, about 1.1 us; the 8-level
// pyramid of one image (1,444,097 px) is 11.6 MB, about 3.4 us, and a
// stereo frame about 6.9 us in 16 launches. At these sizes the launch
// latency, not the bytes, dominates. Making it fast (one launch per
// pyramid, fusing the per-cell argmax) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;           // outputs per block side
constexpr int kRing = kTile + 2;    // response tile with its NMS ring
constexpr int kHalo = 4;            // input halo: circle radius 3 + ring 1
constexpr int kIn = kTile + 2 * kHalo;
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kBorder = 3;
constexpr int kArc = 9;

__constant__ int kCircleDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kCircleDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

// Bit j of the result is set iff the 9-arc starting at circle index j is
// all set in the 16-bit mask m (cyclic).
__device__ __forceinline__ uint32_t arc_runs(uint32_t m) {
  uint32_t m2 = m | (m << 16);
  uint32_t r = m2;
#pragma unroll
  for (int s = 1; s < kArc; ++s) r &= m2 >> s;
  return r;
}

// Max over valid arc starts of the excess summed along the arc, in the
// order j, j+1, ..., j+8 starting from 0 (the plain version's order).
__device__ __forceinline__ float arc_best(uint32_t run, const float* e) {
  float best = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kArc; ++k) s += e[(j + k) & 15];
    float v = ((run >> j) & 1u) ? s : 0.f;
    best = fmaxf(best, v);
  }
  return best;
}

__global__ void __launch_bounds__(kThreadsX * kThreadsY)
fast_resp_pref_kernel(const float* __restrict__ in, float* __restrict__ out,
                      int H, int W, float th_lo, float th_hi) {
  __shared__ float tile[kIn][kIn + 1];
  __shared__ float resp[kRing][kRing + 1];
  __shared__ uint8_t hi[kRing][kRing];

  const int x0 = blockIdx.x * kTile;
  const int y0 = blockIdx.y * kTile;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const int nthreads = kThreadsX * kThreadsY;

  // 1. Stage the input tile with its halo, edge-replicated.
  for (int i = tid; i < kIn * kIn; i += nthreads) {
    int ty = i / kIn, tx = i % kIn;
    int y = min(max(y0 - kHalo + ty, 0), H - 1);
    int x = min(max(x0 - kHalo + tx, 0), W - 1);
    tile[ty][tx] = in[(size_t)y * W + x];
  }
  __syncthreads();

  // 2. Response and high-threshold flag over the tile and its ring.
  for (int i = tid; i < kRing * kRing; i += nthreads) {
    int ry = i / kRing, rx = i % kRing;
    int y = y0 - 1 + ry, x = x0 - 1 + rx;
    float r = 0.f;
    uint8_t h = 0;
    if (y >= kBorder && y < H - kBorder && x >= kBorder && x < W - kBorder) {
      const int cy = ry + kHalo - 1, cx = rx + kHalo - 1;
      const float c = tile[cy][cx];
      float eb[16], ed[16];
      uint32_t lo_b = 0, lo_d = 0, hi_b = 0, hi_d = 0;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        float d = tile[cy + kCircleDy[k]][cx + kCircleDx[k]] - c;
        lo_b |= (uint32_t)(d > th_lo) << k;
        lo_d |= (uint32_t)(d < -th_lo) << k;
        hi_b |= (uint32_t)(d > th_hi) << k;
        hi_d |= (uint32_t)(d < -th_hi) << k;
        eb[k] = fmaxf(d - th_lo, 0.f);
        ed[k] = fmaxf(-d - th_lo, 0.f);
      }
      uint32_t run_b = arc_runs(lo_b), run_d = arc_runs(lo_d);
      if ((run_b | run_d) & 0xFFFFu) {
        r = fmaxf(arc_best(run_b, eb), arc_best(run_d, ed));
      }
      h = ((arc_runs(hi_b) | arc_runs(hi_d)) & 0xFFFFu) != 0;
    }
    resp[ry][rx] = r;
    hi[ry][rx] = h;
  }
  __syncthreads();

  // 3. NMS over the inner tile, the bonus, and the write.
  const int tx = threadIdx.x;
  for (int ty = threadIdx.y; ty < kTile; ty += kThreadsY) {
    int y = y0 + ty, x = x0 + tx;
    if (y >= H || x >= W) continue;
    float c = resp[ty + 1][tx + 1];
    bool keep = c > 0.f;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        keep = keep && (c >= resp[ty + 1 + dy][tx + 1 + dx]);
      }
    }
    float v = keep ? c : 0.f;
    if (keep && hi[ty + 1][tx + 1]) v = c + 1e4f;
    out[(size_t)y * W + x] = v;
  }
}

}  // namespace

extern "C" int fast_resp_pref_launch(const float* in, float* out, int H, int W,
                                     float th_lo, float th_hi, void* stream) {
  dim3 block(kThreadsX, kThreadsY);
  dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  fast_resp_pref_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(in, out, H, W, th_lo, th_hi);
  return (int)cudaGetLastError();
}
