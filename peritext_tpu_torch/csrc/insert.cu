// Sequential RGA insert phase for a batch of documents, for Hopper (sm_90a).
//
// Replaces the TPU kernels _insert_kernel and _insert_kernel_chunked of the
// reference package (ops/pallas_insert.py): every one of a document's K
// inserts, in order, on its (elem_id, char) rows, with the step loop of
// insert_steps.cuh on a window of s_loop slots (the capacity).
//
// What bounds it on this card: per step a doc's threads scan its n live
// slots twice and move (n - q) of them, and the two scans and the shift are
// separated by block barriers.  At the main path's shapes (a few hundred
// slots per doc) that latency chain, not device-memory bytes or integer
// issue rate, sets the time.  The design keeps everything the chain touches
// on chip: one thread block per doc, the doc's s_loop window in dynamic
// shared memory, reductions by warp shuffles plus one shared word per warp,
// and the op stream read once per step (a broadcast load).  When the window
// does not fit the shared-memory budget, the same body runs on the output
// rows in device memory (global variant), so the kernel serves every size.
//
// Plain C interface, loaded with ctypes (ops/insert.py).  The launch
// returns its cudaError_t; it never synchronises.

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

#include "insert_steps.cuh"

namespace {

using peritext::insert_steps;
using peritext::kMaxThreads;

template <bool kShared>
__global__ void __launch_bounds__(kMaxThreads) insert_kernel(
    const int* __restrict__ elem_in, const int* __restrict__ char_in,
    const int* __restrict__ n_in, const unsigned char* __restrict__ ov_in,
    const int* __restrict__ ins_ref, const int* __restrict__ ins_op,
    const int* __restrict__ ins_char, int* elem_out, int* char_out,
    int* __restrict__ n_out, unsigned char* __restrict__ ov_out,
    int slot_capacity, int s_loop, int num_ops) {
  extern __shared__ int window[];
  __shared__ int red[2][32];

  const int d = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const size_t row = static_cast<size_t>(d) * slot_capacity;

  int* elem;
  int* chars;
  if (kShared) {
    elem = window;
    chars = window + s_loop;
    for (int j = tid; j < s_loop; j += nthreads) {
      elem[j] = elem_in[row + j];
      chars[j] = char_in[row + j];
    }
    // slots past the window are untouched by construction
    for (int j = s_loop + tid; j < slot_capacity; j += nthreads) {
      elem_out[row + j] = elem_in[row + j];
      char_out[row + j] = char_in[row + j];
    }
  } else {
    elem = elem_out + row;
    chars = char_out + row;
    for (int j = tid; j < slot_capacity; j += nthreads) {
      elem[j] = elem_in[row + j];
      chars[j] = char_in[row + j];
    }
  }
  int n = n_in[d];
  int ov = ov_in[d] != 0;
  __syncthreads();

  const size_t srow = static_cast<size_t>(d) * num_ops;
  insert_steps(elem, chars, n, ov, ins_ref + srow, ins_op + srow,
               ins_char + srow, num_ops, s_loop, red);

  if (kShared) {
    for (int j = tid; j < s_loop; j += nthreads) {
      elem_out[row + j] = elem[j];
      char_out[row + j] = chars[j];
    }
  }
  if (tid == 0) {
    n_out[d] = n;
    ov_out[d] = static_cast<unsigned char>(ov);
  }
}

}  // namespace

extern "C" int peritext_insert_batch(
    const int* elem_in, const int* char_in, const int* n_in,
    const unsigned char* ov_in, const int* ins_ref, const int* ins_op,
    const int* ins_char, int* elem_out, int* char_out, int* n_out,
    unsigned char* ov_out, int num_docs, int slot_capacity, int s_loop,
    int num_ops, int use_shared, int threads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (use_shared) {
    const size_t bytes = 2 * static_cast<size_t>(s_loop) * sizeof(int);
    cudaError_t err = cudaFuncSetAttribute(
        insert_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear, and report this one
      return static_cast<int>(err);
    }
    insert_kernel<true><<<num_docs, threads, bytes, st>>>(
        elem_in, char_in, n_in, ov_in, ins_ref, ins_op, ins_char, elem_out,
        char_out, n_out, ov_out, slot_capacity, s_loop, num_ops);
  } else {
    insert_kernel<false><<<num_docs, threads, 0, st>>>(
        elem_in, char_in, n_in, ov_in, ins_ref, ins_op, ins_char, elem_out,
        char_out, n_out, ov_out, slot_capacity, s_loop, num_ops);
  }
  return static_cast<int>(cudaGetLastError());
}
