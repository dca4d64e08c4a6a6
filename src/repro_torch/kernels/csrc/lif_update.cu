// Fused partial-update LIF neuron step for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of src/repro/kernels/lif_update.py
// (entry point `lif_update`, the `pl.pallas_call` there).  Elementwise over
// (B, N), one read of v / elapsed / current and one write of each output:
//   has_input = current != 0        (-0.0 counts as no input; this is not
//                                    the fused kernel's touch count)
//   touched:   v_int = v * leak ** (elapsed + 1) + current, spike where
//              v_int >= threshold, v' = spike ? reset : v_int, elapsed' = 0
//   untouched: v' = v, elapsed' = elapsed + 1, no spike
//   updated    = has_input as int8, spikes as f32.
// The epilogue is fused_timestep.cu's: powf for the lazy decay, then an
// explicitly rounded multiply and add, so no FMA contraction makes v'
// differ from the plain version's two rounded operations.
//
// Bound on an H100 SXM (3.35 TB/s): memory, 25 bytes per element (12 read,
// 13 written); at (640, 4096) about 24 us, at one step of the paper's
// network (M = 32) about 1 us for layer 1 and far less for layers 2 and 3,
// where a launch and the card's drain set the pace.  The TPU kernel's
// (8, 128) tiling is not needed here: a grid-stride loop with one element
// per thread and step reads and writes each array with consecutive threads
// on consecutive addresses, and no padding is needed for ragged shapes or
// views at any offset.  Four elements a thread through 16-byte accesses
// lost at M = 32, where one element a thread keeps more warps in flight
// and each thread's powf chain short (PERF.md, PR 18).
//
// The kernel is launched as a programmatic dependent of the previous one on
// the stream, so its blocks are scheduled while that grid drains.  It waits
// for that grid (griddepcontrol.wait) before its first load and its first
// store, since the caching allocator may hand it a buffer the previous
// kernel still reads, and lets the next grid be scheduled once a thread's
// loads are issued (earlier, at the wait, or later, after the loop, both
// lost at M = 32).
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 32;  // grid-stride beyond this

__global__ void __launch_bounds__(kThreads) lif_update_kernel(
    const float* __restrict__ v, const int* __restrict__ elapsed,
    const float* __restrict__ current, float* __restrict__ v_out,
    int* __restrict__ el_out, float* __restrict__ spikes,
    int8_t* __restrict__ updated, long long count, float threshold,
    float leak, float reset) {
  hopper::griddepcontrol_wait();
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < count; i += stride) {
    const float cur = current[i];
    const float v0 = v[i];
    const int pending = elapsed[i] + 1;
    hopper::griddepcontrol_launch_dependents();
    const bool has_input = cur != 0.f;
    float v_new = v0, spk = 0.f;
    int el_new = pending;
    if (has_input) {
      const float decay = powf(leak, (float)pending);
      const float v_int = __fadd_rn(__fmul_rn(v0, decay), cur);
      const bool fire = v_int >= threshold;
      spk = fire ? 1.f : 0.f;
      v_new = fire ? reset : v_int;
      el_new = 0;
    }
    v_out[i] = v_new;
    el_out[i] = el_new;
    spikes[i] = spk;
    updated[i] = has_input ? 1 : 0;
  }
  hopper::griddepcontrol_launch_dependents();  // a thread with no element
}

}  // namespace

extern "C" {

int lif_update_launch(const void* v, const void* elapsed, const void* current,
                      void* v_out, void* el_out, void* spikes, void* updated,
                      long long count, float threshold, float leak,
                      float reset, void* stream) {
  if (count <= 0) return (int)cudaSuccess;
  long long blocks = (count + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, lif_update_kernel, static_cast<const float*>(v),
      static_cast<const int*>(elapsed), static_cast<const float*>(current),
      static_cast<float*>(v_out), static_cast<int*>(el_out),
      static_cast<float*>(spikes), static_cast<int8_t*>(updated), count,
      threshold, leak, reset);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* lif_update_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
