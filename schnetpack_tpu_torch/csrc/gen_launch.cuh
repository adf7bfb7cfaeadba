// Host helpers of the general instances' launchers (colblock_message_gen.cu,
// schnet_columns_gen.cu): the device's opt-in shared memory limit, queried
// once per device, and each kernel's dynamic shared memory limit raised to
// it once per kernel and device, so that a launch makes neither call; and
// the scratch in global memory of the instances whose working tiles do
// not fit a block's shared memory.  Everything here has internal linkage;
// each source includes it once.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kMaxDevices = 64;
constexpr int kMaxAllowed = 256;

// cudaDevAttrMaxSharedMemoryPerBlockOptin of the current device
inline int optin_smem() {
  static int lim[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < kMaxDevices && lim[dev] > 0) return lim[dev];
  int v = 0;
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (dev < kMaxDevices) lim[dev] = v;
  return v;
}

// multiprocessors of the current device
inline int sm_count() {
  static int cnt[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < kMaxDevices && cnt[dev] > 0) return cnt[dev];
  int v = 0;
  cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
  if (dev < kMaxDevices) cnt[dev] = v;
  return v;
}

// Scratch of the launches whose blocks keep their working tiles in global
// memory (shapes past what shared memory holds): a launch of `blocks`
// blocks of `per_block` bytes each runs in waves of at most 4 blocks a
// multiprocessor and kScratchBytes of scratch, which every wave reuses
// (the waves run in stream order); the scratch comes from the stream's
// pool and goes back to it after the last wave.
constexpr size_t kScratchBytes = (size_t)256 << 20;

template <typename Launch>
cudaError_t in_waves(int blocks, size_t per_block, cudaStream_t stream,
                     Launch launch) {
  const size_t cap = std::max<size_t>(1, kScratchBytes / per_block);
  const int wave = (int)std::min<size_t>(
      {(size_t)blocks, (size_t)4 * sm_count(), cap});
  void* scr = nullptr;
  cudaError_t err = cudaMallocAsync(&scr, (size_t)wave * per_block, stream);
  if (err != cudaSuccess) return err;
  for (int v0 = 0; v0 < blocks && err == cudaSuccess; v0 += wave) {
    launch(static_cast<float*>(scr), v0, std::min(wave, blocks - v0));
    err = cudaGetLastError();
  }
  const cudaError_t fr = cudaFreeAsync(scr, stream);
  return err != cudaSuccess ? err : fr;
}

// Let `kernel` (no static shared memory) take up to the opt-in limit of
// dynamic shared memory on the current device: set once per kernel and
// device (the attribute only permits; each launch asks for its own size).
inline cudaError_t allow_smem(const void* kernel) {
  static const void* fn[kMaxAllowed];
  static int on[kMaxAllowed];
  static int n = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  for (int i = 0; i < n; ++i)
    if (fn[i] == kernel && on[i] == dev) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin_smem());
  if (err == cudaSuccess && n < kMaxAllowed) {
    fn[n] = kernel;
    on[n++] = dev;
  }
  return err;
}

}  // namespace
