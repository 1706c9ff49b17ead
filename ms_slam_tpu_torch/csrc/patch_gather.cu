// Keypoint patch gather for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel ms_slam_tpu/ops/orb.py:616-719
// (_patch_kernel_body + extract_patches_canvas_pallas). For each keypoint k
// of image bi[k] it copies the raw (2R+1)x(2R+1) = 45x45 float patch centred
// on (ys[k], xs[k]) of that image's packed pyramid canvas (B, H, Wc), with
// the centre clipped to [R, H-R-1] x [R, Wc-R-1] exactly as the reference
// clips it. Output: (n, 45, 45) float32, keypoint-major.
//
// What bounds it on the card: memory traffic, chiefly the 8.1 KB written per
// keypoint (about 33 MB per frame at 2 x 2048 keypoints; the reads are the
// same size but hit L2, since both 9 MB canvases fit in the H100's 50 MB L2).
// The TPU version stages a whole canvas in VMEM and reads aligned (8,128)
// windows rotated into place with pltpu.roll; that trick exists only for
// Mosaic's load alignment and is not carried over. Here a block takes a
// small group of keypoints and its threads walk the patch in output order,
// so the stores are fully contiguous and a warp's 32 loads fall in at most
// two contiguous 180-byte patch rows.
//
// Plain C interface (loaded with ctypes): launches on the given stream, does
// not synchronise, allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kR = 22;                 // EXTRACT_R in ops/orb.py
constexpr int kE = 2 * kR + 1;         // 45
constexpr int kEE = kE * kE;           // 2025 floats per patch
constexpr int kKeypointsPerBlock = 4;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
patch_gather_kernel(const float* __restrict__ canvas,
                    const int* __restrict__ bi,
                    const int* __restrict__ ys,
                    const int* __restrict__ xs,
                    float* __restrict__ out,
                    int n, int B, int H, int Wc) {
  for (int j = 0; j < kKeypointsPerBlock; ++j) {
    const int k = blockIdx.x * kKeypointsPerBlock + j;
    if (k >= n) return;
    const int b = min(max(bi[k], 0), B - 1);
    const int y = min(max(ys[k], kR), H - kR - 1);
    const int x = min(max(xs[k], kR), Wc - kR - 1);
    const float* src =
        canvas + ((size_t)b * H + (size_t)(y - kR)) * Wc + (size_t)(x - kR);
    float* dst = out + (size_t)k * kEE;
    for (int i = threadIdx.x; i < kEE; i += kThreads) {
      const int r = i / kE;
      const int c = i - r * kE;
      dst[i] = __ldg(src + (size_t)r * Wc + c);
    }
  }
}

}  // namespace

extern "C" int msslam_patch_gather_f32(const float* canvas, const int* bi,
                                       const int* ys, const int* xs,
                                       float* out, int n, int B, int H,
                                       int Wc, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kKeypointsPerBlock - 1) / kKeypointsPerBlock;
  patch_gather_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      canvas, bi, ys, xs, out, n, B, H, Wc);
  return (int)cudaGetLastError();
}
