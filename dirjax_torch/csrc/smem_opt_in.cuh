// A kernel's opt-in to more than 48 KB of dynamic shared memory, safe when
// several host threads launch it at once.
//
// cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
// bytes) sets one value per function and device for the whole process. A
// launcher that set it to each launch's own size before the launch raced
// with itself on another thread: thread A set 150 KB, thread B set 70 KB,
// and A's launch at 150 KB then failed with cudaErrorInvalidValue. So each
// launcher opts in once per kernel and device, to the most that kernel can
// ever be asked for, and never sets a smaller value afterwards. Threads that
// meet the unset flag together all set the same value, which is harmless.
//
// This changes no launch: each launch still passes its own size as the
// <<<>>> argument, and the occupancy and the carve-out of the SM's shared
// memory follow that argument, not the opt-in, which is only a ceiling.

#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kOptInDevices = 64;

using OptInFlags = std::atomic<bool>[kOptInDevices];

// Raises `kernel`'s dynamic shared-memory ceiling on the current device to
// `most` bytes unless `done` (one flag a device, owned by the caller for this
// kernel) says it was raised already; `smem`, this launch's size, must not
// exceed `most`.
template <typename Kernel>
cudaError_t opt_in_once(Kernel kernel, int most, int smem, OptInFlags& done) {
  if (smem > most) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kOptInDevices) return cudaErrorInvalidDevice;
  if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err == cudaSuccess) done[dev].store(true, std::memory_order_release);
  return err;
}

}  // namespace
