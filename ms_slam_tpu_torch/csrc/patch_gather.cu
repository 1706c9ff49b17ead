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
// value widened, which is exact (its bits shifted left by 16). Its bound at
// the stereo shape: the bf16 canvas 9,043,968 B, the output 33,177,600 B and
// the indices 49,152 B, 12.6 us at 3.35 TB/s. The output is 78% of the
// bytes, so the design keeps loads in flight and the stores streaming:
//  - TMA tile loads. A bf16 row of 45 values is 90 B at any 2-byte offset,
//    which no 4-byte cp.async can fetch. A tensor map over the canvas,
//    dims (Wc, H, B), box (56, 45, 1), cuts each patch as one 56 x 45 tile
//    (112 B rows): one cp.async.bulk.tensor per keypoint, completing on the
//    stage's mbarrier. A box must start on a 16-byte-aligned column (one
//    2 bytes off raised an illegal instruction on an H100), so the tile
//    starts at the patch's first column rounded down to a multiple of 8 and
//    the patch lies 0-7 columns into it. Past Wc (only near the right clip
//    edge) TMA fills zeros, which are never copied. The map needs a
//    16-byte-aligned canvas and Wc % 8 == 0 (its row pitch a multiple of
//    16 B); the wrapper refuses any other bf16 canvas. The entry point keeps
//    the last canvas's map and encodes a new one only for a new canvas.
//  - Widening on the way out. Once a group's four tiles have landed, each
//    thread widens four consecutive output values from them and writes the
//    four with one 16-byte evict-first store (a group's 32,400 B start
//    16-byte aligned). No f32 copy of the group is staged: staging it in
//    shared memory and writing it with one bulk copy, as the f32 kernel
//    does, took 0.0195 ms against this design's 0.0170-0.0175 ms at the
//    stereo shape on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md). The
//    n % 4 tail goes by 4-byte stores.
//  - Overlap. Blocks are persistent (as many as fit on the card: 20 KB of
//    tiles a stage, two stages, five blocks an SM; each walks groups
//    blockIdx.x, blockIdx.x + gridDim.x, ...): while group i is widened and
//    stored, group i+1's tiles are in flight. No wave tail.

// Plain C interface (loaded with ctypes): launches on the given stream, does
// not synchronise, allocates nothing, returns a cudaError_t as an int.

#include <cuda.h>              // CUtensorMap and its enums: types only (the
#include <cuda_bf16.h>         // encoder is looked up: see encode_tiled)
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

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

constexpr int kBoxW = 56;                       // tile columns: 112 B rows
constexpr int kTileBytes = kBoxW * kE * 2;      // 5040 B of bf16 a patch
constexpr int kTileStride = 5120;               // tiles 128-byte aligned
constexpr int kStages = 2;
constexpr int kStageBytes = kGroup * kTileStride;             // 20,480 B
// after the stages: a barrier (8 B) and the tiles' four column offsets
// (16 B) a stage, then slack for aligning the dynamic shared memory
constexpr int kBf16Smem = kStages * kStageBytes + kStages * 24 + 128;

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

// Warp 0: arms stage barrier `bar` with group g's bytes, then lanes
// 0..count-1 each start their keypoint's tile load (centre clipped and
// image index clamped as in fill_row_table). TMA takes a box only from a
// 16-byte-aligned column (a start 2 bytes off is an illegal instruction on
// the H100), so a tile starts at the patch's first column rounded down to a
// multiple of 8; `offs[lane]` keeps the patch's column within its tile.
__device__ __forceinline__ void load_group(const CUtensorMap* map,
                                           uint32_t tiles, uint32_t bar,
                                           int* offs,
                                           const int* __restrict__ bi,
                                           const int* __restrict__ ys,
                                           const int* __restrict__ xs,
                                           int g, int n, int B, int H,
                                           int Wc) {
  const int k0 = g * kGroup;
  const int count = min(kGroup, n - k0);
  const int lane = threadIdx.x;
  if (lane == 0)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(count * kTileBytes) : "memory");
  __syncwarp();
  if (lane < count) {
    const int k = k0 + lane;
    const int b = min(max(bi[k], 0), B - 1);
    const int y = min(max(ys[k], kR), H - kR - 1);
    const int x0 = min(max(xs[k], kR), Wc - kR - 1) - kR;
    offs[lane] = x0 & 7;
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
        :: "r"(tiles + lane * kTileStride),
           "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x0 & ~7),
           "r"(y - kR), "r"(b)
        : "memory");
  }
}

// the tile element of patch p's column 0 (row 0)
__device__ __forceinline__ int patch_base(const int* offs, int p) {
  return p * (kTileStride / 2) + offs[p];
}

__device__ __forceinline__ float widen(const uint16_t* tiles, int i) {
  return __uint_as_float((uint32_t)tiles[i] << 16);
}

__global__ void __launch_bounds__(kThreads)
patch_gather_bf16_kernel(const __grid_constant__ CUtensorMap canvas_map,
                         const int* __restrict__ bi,
                         const int* __restrict__ ys,
                         const int* __restrict__ xs,
                         float* __restrict__ out,
                         int n, int B, int H, int Wc) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_s = (uint32_t)__cvta_generic_to_shared(smem_raw);
  unsigned char* smem = smem_raw + ((128u - (raw_s & 127u)) & 127u);
  const uint32_t smem_s = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t bar_s = smem_s + kStages * kStageBytes;   // 8 B a stage
  int* offs_all = reinterpret_cast<int*>(smem + kStages * kStageBytes +
                                         8 * kStages);    // 4 ints a stage
  const int groups = (n + kGroup - 1) / kGroup;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                   :: "r"(bar_s + 8 * s), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&canvas_map)) : "memory");
  }
  __syncthreads();
  if (tid < 32)
    for (int s = 0; s < kStages; ++s) {
      const int g = blockIdx.x + s * gridDim.x;
      if (g < groups)
        load_group(&canvas_map, smem_s + s * kStageBytes, bar_s + 8 * s,
                   offs_all + kGroup * s, bi, ys, xs, g, n, B, H, Wc);
    }
  uint64_t evict_first;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(evict_first));

  int i = 0;
  for (int g = blockIdx.x; g < groups; g += gridDim.x, ++i) {
    const int s = i % kStages;
    const int k0 = g * kGroup;
    const int count = min(kGroup, n - k0);
    const uint16_t* tiles =
        reinterpret_cast<const uint16_t*>(smem + s * kStageBytes);
    const int* offs = offs_all + kGroup * s;
    float* dst = out + (size_t)k0 * kEE;
    mbar_wait(bar_s + 8 * s, (i / kStages) & 1);    // the tiles have landed
    if (count == kGroup) {
      // one float4 of the output a step: output element e of the group is
      // patch p, row r, column c, read at tile p's (r, offs[p] + c); the
      // group's 32,400 B start 16-byte aligned, so each store is one
      // 16-byte evict-first store (the output is not read again here)
      for (int q = tid; q < kGroupFloats / 4; q += kThreads) {
        const int e = 4 * q;
        int p = e / kEE;
        int r = (e - p * kEE) / kE;
        int c = e - p * kEE - r * kE;
        int base = patch_base(offs, p);
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          v[u] = widen(tiles, base + r * kBoxW + c);
          if (++c == kE) {
            c = 0;
            if (++r == kE) {
              r = 0;
              p = min(p + 1, kGroup - 1);   // the group's last element ends p
              base = patch_base(offs, p);
            }
          }
        }
        asm volatile(
            "st.global.L2::cache_hint.v4.f32 [%0], {%1, %2, %3, %4}, %5;\n"
            :: "l"(dst + e), "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3]),
               "l"(evict_first)
            : "memory");
      }
    } else {                          // the n % 4 tail: 4-byte stores
      for (int e = tid; e < count * kEE; e += kThreads) {
        const int p = e / kEE;
        const int r = (e - p * kEE) / kE;
        dst[e] = widen(tiles, patch_base(offs, p) + r * kBoxW +
                                  (e - p * kEE - r * kE));
      }
    }
    __syncthreads();
    // every thread is done with this stage's tiles: load group i + kStages
    const int g_next = g + kStages * gridDim.x;
    if (tid < 32 && g_next < groups)
      load_group(&canvas_map, smem_s + s * kStageBytes, bar_s + 8 * s, offs_all
                 + kGroup * s, bi, ys, xs, g_next, n, B, H, Wc);
  }
}

// cuTensorMapEncodeTiled looked up through the CUDA runtime at first use, so
// the library links nothing but the CUDA runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// What the bf16 entry point keeps per device, under one lock: the kernel's
// resident blocks (the SM count times the blocks one SM holds at kBf16Smem
// bytes; the shared-memory attribute is set on first use) and the tensor
// map of the last canvas, re-encoded only when the canvas's address or
// shape changes (a map holds nothing else).
struct Bf16Device {
  int resident = 0;
  const void* canvas = nullptr;
  int B = 0, H = 0, Wc = 0;
  CUtensorMap map;
};
std::mutex bf16_mu;
Bf16Device bf16_devices[64];

cudaError_t bf16_device(int* dev) {    // bf16_mu held
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return e;
  if (*dev >= 64) return cudaErrorInvalidDevice;
  Bf16Device& d = bf16_devices[*dev];
  if (d.resident == 0) {
    int sms = 0, per_sm = 0;
    if ((e = cudaFuncSetAttribute(patch_gather_bf16_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kBf16Smem)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    *dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, patch_gather_bf16_kernel, kThreads, kBf16Smem)) !=
            cudaSuccess)
      return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    d.resident = sms * per_sm;
  }
  return cudaSuccess;
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
  if ((reinterpret_cast<uintptr_t>(out) & 15)        // the 16-byte stores'
      || (reinterpret_cast<uintptr_t>(canvas) & 15)  // and the tensor map's
      || (Wc % 8))                                   // (row pitch) alignment
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap map;
  int resident, dev;
  {
    std::lock_guard<std::mutex> lock(bf16_mu);
    const cudaError_t e = bf16_device(&dev);
    if (e != cudaSuccess) return (int)e;
    Bf16Device& d = bf16_devices[dev];
    if (d.canvas != canvas || d.B != B || d.H != H || d.Wc != Wc) {
      const EncodeTiled encode = encode_tiled();
      if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
      const cuuint64_t dims[3] = {(cuuint64_t)Wc, (cuuint64_t)H,
                                  (cuuint64_t)B};
      const cuuint64_t pitch[2] = {2ull * Wc, 2ull * H * Wc};   // bytes
      const cuuint32_t box[3] = {kBoxW, kE, 1};
      const cuuint32_t step[3] = {1, 1, 1};
      d.canvas = nullptr;
      if (encode(&d.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                 const_cast<__nv_bfloat16*>(canvas), dims, pitch, box, step,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return (int)cudaErrorInvalidValue;
      d.canvas = canvas;
      d.B = B;
      d.H = H;
      d.Wc = Wc;
    }
    map = d.map;
    resident = d.resident;
  }
  const int groups = (n + kGroup - 1) / kGroup;
  patch_gather_bf16_kernel<<<min(groups, resident), kThreads, kBf16Smem,
                             (cudaStream_t)stream>>>(map, bi, ys, xs, out, n,
                                                     B, H, Wc);
  return (int)cudaGetLastError();
}

// The bf16 kernel's resident blocks on the current device (its grid at
// most), or minus a cudaError_t; for reports.
extern "C" int msslam_patch_gather_bf16_resident_blocks() {
  std::lock_guard<std::mutex> lock(bf16_mu);
  int dev;
  const cudaError_t e = bf16_device(&dev);
  return e == cudaSuccess ? bf16_devices[dev].resident : -(int)e;
}
