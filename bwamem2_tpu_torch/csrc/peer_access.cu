// peer_access: the host side of the sharded index's peer loads (no
// kernel).  parallel/shard_index.py allocates each card's shard of the
// occ and SA tables here with cudaMalloc, and enables peer access from
// every card of the index to every other, so that a kernel on one card
// reads another card's shard directly (fm_occ.cuh:FmShardView) over
// NVLink.  Memory from cudaMalloc is what cudaDeviceEnablePeerAccess maps
// to the peers; memory that PyTorch's allocator maps itself
// (expandable_segments) would need cuMemSetAccess instead, so the shards
// do not come from it.  Every function returns a CUDA error code and
// leaves the calling thread's current device as it found it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// run f with `dev` current, then restore the caller's device
template <class F>
int on_device(int dev, F f) {
    int prev = 0;
    cudaError_t err = cudaGetDevice(&prev);
    if (!err) err = cudaSetDevice(dev);
    if (err) return (int)err;
    err = f();
    const cudaError_t back = cudaSetDevice(prev);
    return (int)(err ? err : back);
}

}  // namespace

// Let kernels on card `dev` read memory of card `peer`:
// cudaErrorPeerAccessUnsupported when the two cannot reach each other;
// access enabled before is success.
extern "C" int peer_enable(int dev, int peer) {
    int can = 0;
    cudaError_t err = cudaDeviceCanAccessPeer(&can, dev, peer);
    if (err) return (int)err;
    if (!can) return (int)cudaErrorPeerAccessUnsupported;
    return on_device(dev, [&] {
        cudaError_t e = cudaDeviceEnablePeerAccess(peer, 0);
        if (e == cudaErrorPeerAccessAlreadyEnabled) {
            cudaGetLastError();           // clear it: not a failure
            e = cudaSuccess;
        }
        return e;
    });
}

// `bytes` of device memory on card `dev` at *ptr
extern "C" int peer_alloc(int dev, int64_t bytes, void **ptr) {
    return on_device(dev, [&] { return cudaMalloc(ptr, (size_t)bytes); });
}

extern "C" int peer_free(int dev, void *ptr) {
    return on_device(dev, [&] { return cudaFree(ptr); });
}
