// The step clock's stage stamp (telemetry/steps.py): a one-thread
// kernel that a CUDA graph capture of the fused step takes in at each
// stage mark, on the step's own stream, between the stage before and
// the stage after.
//
// It reads %globaltimer (ns) and adds the time since the previous mark
// to the slot of the interval that ends at this mark, so a graph's
// stamps accumulate over every replay into one small device buffer
// that the host reads only at read-out:
//
//   acc[0]          the previous mark's stamp
//   acc[1]          replays that reached their last mark
//   acc[1 + k]      the interval from mark k - 1 to mark k (k >= 1)
//
// A mark is a kernel node and not an event-record node: a graph that
// holds timing-event record nodes waits on the host at each launch for
// its previous replay to finish, and its nodes hold only their latest
// replay. The replays of one graph run one after another on its stream,
// so the read-modify-writes here never race.

#include <cuda_runtime.h>

__global__ void step_stamp(unsigned long long* acc, int k, int last) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  if (k > 0) acc[1 + k] += t - acc[0];
  acc[0] = t;
  if (last) acc[1] += 1;
}

// the stamp of mark k (``last`` for the step's end) on ``stream``
extern "C" int step_stamp_launch(void* acc, int k, int last, void* stream) {
  step_stamp<<<1, 1, 0, (cudaStream_t)stream>>>((unsigned long long*)acc, k, last);
  return (int)cudaGetLastError();
}

// loads the kernel on the current device, so that its first launch,
// which a capture takes in, loads no module
extern "C" int step_stamp_ready() {
  cudaFuncAttributes attr;
  return (int)cudaFuncGetAttributes(&attr, step_stamp);
}
