// A fixed-address device range for a model's weights, on CUDA's
// virtual-memory-management API (libcuda's cuMem* calls).
//
// Replaces no TPU kernel. The JAX weight pager
// (localai_tfp_tpu/engine/weight_pager.py) frees a model's weights and
// builds a new tree when it promotes them back: XLA executables take the
// weights as arguments, so new buffers cost nothing there. The port's
// dispatches are CUDA-graph replays captured over the addresses of the
// weight tensors, so the weights must come back at the SAME virtual
// addresses, or every graph would have to be captured again (seconds at
// 8B). This file keeps one reserved virtual range per engine: physical
// memory is mapped under it while the weights are hot and unmapped (its
// memory released) while they are warm in host RAM.
//
// Nothing here is bound by bytes or operations: each call is one cuMem*
// call or a few, made on the pager's own thread (never inside a capture
// and never on the scheduler's thread). The copies in and out are
// PyTorch's own copy_ on a side stream.
//
// Plain C interface, loaded with ctypes (ops/_build.py links this source
// with -lcuda). Every function returns a CUresult (0 = success); the
// Python side (models/weight_slab.py) raises on anything else.

#include <cuda.h>
#include <stdint.h>
#include <string.h>

// The calling thread's current context: the device's primary context,
// the one PyTorch's runtime uses. The pager calls from threads of its own,
// which may have no current context yet.
static CUresult bind(int device) {
  CUresult r = cuInit(0);
  if (r != CUDA_SUCCESS) return r;
  CUdevice dev;
  r = cuDeviceGet(&dev, device);
  if (r != CUDA_SUCCESS) return r;
  CUcontext ctx;
  r = cuDevicePrimaryCtxRetain(&ctx, dev);
  if (r != CUDA_SUCCESS) return r;
  r = cuCtxSetCurrent(ctx);
  // the runtime holds its own reference to the primary context
  cuDevicePrimaryCtxRelease(dev);
  return r;
}

static CUmemAllocationProp prop_of(int device) {
  CUmemAllocationProp prop;
  memset(&prop, 0, sizeof(prop));
  prop.type = CU_MEM_ALLOCATION_TYPE_PINNED;
  prop.location.type = CU_MEM_LOCATION_TYPE_DEVICE;
  prop.location.id = device;
  return prop;
}

extern "C" {

// The granularity that every size and offset of a mapping is a multiple
// of (CU_MEM_ALLOC_GRANULARITY_MINIMUM; 2 MiB on an H100).
int wvmm_granularity(int device, uint64_t* out) {
  CUresult r = bind(device);
  if (r != CUDA_SUCCESS) return r;
  CUmemAllocationProp prop = prop_of(device);
  size_t g = 0;
  r = cuMemGetAllocationGranularity(&g, &prop,
                                    CU_MEM_ALLOC_GRANULARITY_MINIMUM);
  *out = (uint64_t)g;
  return r;
}

// Reserve `size` bytes of virtual addresses (a multiple of the
// granularity); no memory behind them yet.
int wvmm_reserve(int device, uint64_t size, uint64_t* out_ptr) {
  CUresult r = bind(device);
  if (r != CUDA_SUCCESS) return r;
  CUdeviceptr ptr = 0;
  r = cuMemAddressReserve(&ptr, (size_t)size, 0, 0, 0);
  *out_ptr = (uint64_t)ptr;
  return r;
}

// Create `size` bytes of physical memory on the device, map them at
// `ptr` (inside a reserved range) and make them readable and writable by
// the device. On failure nothing stays created or mapped.
int wvmm_map(int device, uint64_t ptr, uint64_t size, uint64_t* out_handle) {
  CUresult r = bind(device);
  if (r != CUDA_SUCCESS) return r;
  CUmemAllocationProp prop = prop_of(device);
  CUmemGenericAllocationHandle h = 0;
  r = cuMemCreate(&h, (size_t)size, &prop, 0);
  if (r != CUDA_SUCCESS) return r;
  r = cuMemMap((CUdeviceptr)ptr, (size_t)size, 0, h, 0);
  if (r != CUDA_SUCCESS) {
    cuMemRelease(h);
    return r;
  }
  CUmemAccessDesc access;
  memset(&access, 0, sizeof(access));
  access.location.type = CU_MEM_LOCATION_TYPE_DEVICE;
  access.location.id = device;
  access.flags = CU_MEM_ACCESS_FLAGS_PROT_READWRITE;
  r = cuMemSetAccess((CUdeviceptr)ptr, (size_t)size, &access, 1);
  if (r != CUDA_SUCCESS) {
    cuMemUnmap((CUdeviceptr)ptr, (size_t)size);
    cuMemRelease(h);
    return r;
  }
  *out_handle = (uint64_t)h;
  return CUDA_SUCCESS;
}

// Unmap one mapping made by wvmm_map and give its memory back to the
// device. The caller has made sure that no work still reads it.
int wvmm_unmap(int device, uint64_t ptr, uint64_t size, uint64_t handle) {
  CUresult r = bind(device);
  if (r != CUDA_SUCCESS) return r;
  r = cuMemUnmap((CUdeviceptr)ptr, (size_t)size);
  if (r != CUDA_SUCCESS) return r;
  return cuMemRelease((CUmemGenericAllocationHandle)handle);
}

// Give a reserved range back (every mapping in it unmapped first).
int wvmm_free(int device, uint64_t ptr, uint64_t size) {
  CUresult r = bind(device);
  if (r != CUDA_SUCCESS) return r;
  return cuMemAddressFree((CUdeviceptr)ptr, (size_t)size);
}

// CUDA's name for a CUresult, into `buf` (NUL-terminated).
void wvmm_error(int code, char* buf, int len) {
  const char* s = nullptr;
  if (cuGetErrorString((CUresult)code, &s) != CUDA_SUCCESS || s == nullptr)
    s = "unknown CUresult";
  strncpy(buf, s, (size_t)len - 1);
  buf[len - 1] = '\0';
}

}  // extern "C"
