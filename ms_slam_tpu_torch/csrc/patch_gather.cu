// Keypoint patch gather for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel extract_patches_canvas_pallas
// (ms_slam_tpu/ops/orb.py:665, body _patch_kernel_body at :616). For each
// keypoint k of image bi[k] it copies the raw (2R+1)x(2R+1) = 45x45 float
// patch centred on (ys[k], xs[k]) of that image's packed pyramid canvas
// (B, H, Wc), with the image index clamped to [0, B-1] and the centre clipped
// to [R, H-R-1] x [R, Wc-R-1] exactly as the reference clips it. Output:
// (n, 45, 45) float32, keypoint-major.
//
// What bounds it on the card: bytes. There is no arithmetic. At the main
// path's shapes (B=2, H=384, Wc=5888, n=4096) the output is 33,177,600 B
// written once, the canvas 18,087,936 B read once and the indices 49,152 B:
// 51,314,688 B, 15.3 us at the H100's 3.35 TB/s. The patches overlap little,
// so a kernel also moves the 33 MB of patch rows from L2 into the SMs.
//
// What the design does about it (the TPU version's whole canvas in VMEM and
// its (8,128) windows turned with pltpu.roll are not carried over):
//  - The group of four. One patch is 8,100 B, 4 mod 16, but four consecutive
//    patches are 32,400 B = 2,025 x 16 B and start 16-byte aligned. A block
//    owns one such group and writes it with a single bulk asynchronous copy
//    (cp.async.bulk, shared to global) started by one thread, so the
//    block's threads execute no store. The copy carries an L2 evict-first
//    policy: the output is not read again by this kernel, and without the
//    hint its 33 MB push the canvases out of the 50 MB L2.
//  - Shared memory as the staging area. Source rows are 180 B at an arbitrary
//    4-byte offset, so they are fetched by 4-byte cp.async straight into the
//    group's place in shared memory, laid out as the output is. Unaligned
//    reads and the aligned write are decoupled, and nothing passes through
//    registers. About six blocks share an SM (33 KB each), which keeps some
//    190 KB of loads in flight per SM.
//  - No division and no serial chain per keypoint. The block first fills a
//    table of its 180 source-row offsets (one thread per row, the indices of
//    all four keypoints loaded at once; the only division is row / 45 there).
//    Then each warp takes pairs of rows: two full-warp copies of columns
//    0-31 and one copy in which the half-warps take columns 32-44 of the two
//    rows, 90 of 96 lanes busy. Offsets are 32-bit; the wrapper refuses a
//    canvas of 2^31 elements or more.
//  - The n % 4 patches after the last whole group are staged the same way
//    and written with 4-byte stores.
//
// The bf16 entry point (msslam_patch_gather_bf16) takes the canvas the
// reference's Pallas kernel is given on its chip: bfloat16, under
// MSSLAM_FORCE_TPU_NUMERICS. It writes the same float32 patches: each bf16
// value widened, which is exact (its bits shifted left by 16). A bf16 row
// of 45 values is 90 B and starts on any 2-byte boundary, so a 4-byte
// cp.async (which needs a 4-byte-aligned source) cannot stage it. Instead
// each thread loads one of the 23 aligned 32-bit words that cover a row
// (whatever the row's parity: 45 values span at most 23 words), widens its
// two values in registers and stores the ones inside the patch into the
// same f32 staging area, laid out as the output. The row table, the single
// bulk write of a whole group and the n % 4 tail are the f32 kernel's.
// Its bound at the stereo shape: the bf16 canvas 9,043,968 B, the output
// 33,177,600 B and the indices 49,152 B, 12.6 us at 3.35 TB/s.
//
// Plain C interface (loaded with ctypes): launches on the given stream, does
// not synchronise, allocates nothing, returns a cudaError_t as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kR = 22;                         // EXTRACT_R in ops/orb.py
constexpr int kE = 2 * kR + 1;                 // 45
constexpr int kEE = kE * kE;                   // 2025 floats per patch
constexpr int kGroup = 4;                      // patches per block
constexpr int kRows = kGroup * kE;             // 180 source rows per group
constexpr int kGroupFloats = kGroup * kEE;     // 8100
constexpr int kGroupBytes = kGroupFloats * 4;  // 32400 = 2025 * 16
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void cp_async_4(uint32_t smem_dst,
                                           const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_dst), "l"(src) : "memory");
}

// Fills the canvas offset of each of the group's source rows' first element;
// returns the number of rows (45 per keypoint of the group).
__device__ __forceinline__ int fill_row_table(int* row_src,
                                              const int* __restrict__ bi,
                                              const int* __restrict__ ys,
                                              const int* __restrict__ xs,
                                              int k0, int count, int B, int H,
                                              int Wc) {
  const int rows = count * kE;
  for (int q = threadIdx.x; q < rows; q += kThreads) {
    const int j = q / kE;
    const int r = q - j * kE;
    const int k = k0 + j;
    const int b = min(max(bi[k], 0), B - 1);
    const int y = min(max(ys[k], kR), H - kR - 1);
    const int x = min(max(xs[k], kR), Wc - kR - 1);
    row_src[q] = (b * H + (y - kR) + r) * Wc + (x - kR);
  }
  __syncthreads();
  return rows;
}

// Writes the staged group (count patches, float32, laid out as the output)
// to out[k0 * 2025 ...]: one bulk copy for a whole group, 4-byte stores for
// the tail. Every thread's writes to `stage` must be complete in its own
// program order (cp.async waited for, or plain stores).
__device__ __forceinline__ void write_group(const float* stage,
                                            uint32_t stage_s, float* dst,
                                            int count) {
  if (count == kGroup) {
    // make the staged group visible to the bulk copy's proxy, then one
    // thread sends all 32,400 bytes and waits until they have been read
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      uint64_t evict_first;
      asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                   : "=l"(evict_first));
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint "
          "[%0], [%1], %2, %3;\n"
          :: "l"(dst), "r"(stage_s), "r"(kGroupBytes), "l"(evict_first)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  } else {
    __syncthreads();
    for (int i = threadIdx.x; i < count * kEE; i += kThreads)
      dst[i] = stage[i];
  }
}

__global__ void __launch_bounds__(kThreads)
patch_gather_kernel(const float* __restrict__ canvas,
                    const int* __restrict__ bi,
                    const int* __restrict__ ys,
                    const int* __restrict__ xs,
                    float* __restrict__ out,
                    int n, int B, int H, int Wc) {
  __shared__ __align__(128) float stage[kGroupFloats];
  __shared__ int row_src[kRows];

  const int k0 = blockIdx.x * kGroup;
  const int count = min(kGroup, n - k0);
  const int rows = fill_row_table(row_src, bi, ys, xs, k0, count, B, H, Wc);

  // rows q, q+1 per warp step: columns 0-31 of each, then 32-44 of both
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;
  const int ctail = 32 + (lane & 15);
  const uint32_t stage_s = (uint32_t)__cvta_generic_to_shared(stage);
  for (int q = 2 * warp; q < rows; q += 2 * kWarps) {
    const bool two = q + 1 < rows;
    const int sa = row_src[q];
    const int sb = two ? row_src[q + 1] : sa;
    cp_async_4(stage_s + 4u * (q * kE + lane), canvas + sa + lane);
    if (two)
      cp_async_4(stage_s + 4u * ((q + 1) * kE + lane), canvas + sb + lane);
    if (ctail < kE && (half == 0 || two))
      cp_async_4(stage_s + 4u * ((q + half) * kE + ctail),
                 canvas + (half ? sb : sa) + ctail);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  write_group(stage, stage_s, out + (size_t)k0 * kEE, count);
}

constexpr int kWords = kE / 2 + 1;   // 23 aligned 32-bit words cover a row

__global__ void __launch_bounds__(kThreads)
patch_gather_bf16_kernel(const __nv_bfloat16* __restrict__ canvas,
                         const int* __restrict__ bi,
                         const int* __restrict__ ys,
                         const int* __restrict__ xs,
                         float* __restrict__ out,
                         int n, int B, int H, int Wc) {
  __shared__ __align__(128) float stage[kGroupFloats];
  __shared__ int row_src[kRows];

  const int k0 = blockIdx.x * kGroup;
  const int count = min(kGroup, n - k0);
  const int rows = fill_row_table(row_src, bi, ys, xs, k0, count, B, H, Wc);
  const int total = B * H * Wc;        // < 2^31, checked by the wrapper

  // one (row, word) pair per thread step: the word holding canvas elements
  // e0 (even) and e0 + 1, which are the row's columns c and c + 1
#pragma unroll 4
  for (int i = threadIdx.x; i < rows * kWords; i += kThreads) {
    const int q = i / kWords;
    const int w = i - q * kWords;
    const int s = row_src[q];
    const int par = s & 1;
    const int e0 = s - par + 2 * w;
    const int c = 2 * w - par;
    float lo, hi = 0.f;
    if (e0 + 1 < total) {
      const __nv_bfloat162 v =
          __ldg(reinterpret_cast<const __nv_bfloat162*>(canvas + e0));
      lo = __low2float(v);
      hi = __high2float(v);
    } else {           // the canvas's last element, at an even index
      lo = __bfloat162float(canvas[e0]);
    }
    float* row = stage + q * kE;
    if (c >= 0) row[c] = lo;
    if (c + 1 < kE) row[c + 1] = hi;
  }
  write_group(stage, (uint32_t)__cvta_generic_to_shared(stage),
              out + (size_t)k0 * kEE, count);
}

}  // namespace

extern "C" int msslam_patch_gather_f32(const float* canvas, const int* bi,
                                       const int* ys, const int* xs,
                                       float* out, int n, int B, int H,
                                       int Wc, void* stream) {
  if (n <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(out) & 15)   // the bulk copy's alignment
    return (int)cudaErrorMisalignedAddress;
  const int blocks = (n + kGroup - 1) / kGroup;
  patch_gather_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      canvas, bi, ys, xs, out, n, B, H, Wc);
  return (int)cudaGetLastError();
}

extern "C" int msslam_patch_gather_bf16(const __nv_bfloat16* canvas,
                                        const int* bi, const int* ys,
                                        const int* xs, float* out, int n,
                                        int B, int H, int Wc, void* stream) {
  if (n <= 0) return 0;
  if ((reinterpret_cast<uintptr_t>(out) & 15)      // the bulk copy's
      || (reinterpret_cast<uintptr_t>(canvas) & 3))  // and the word loads'
    return (int)cudaErrorMisalignedAddress;
  const int blocks = (n + kGroup - 1) / kGroup;
  patch_gather_bf16_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      canvas, bi, ys, xs, out, n, B, H, Wc);
  return (int)cudaGetLastError();
}
