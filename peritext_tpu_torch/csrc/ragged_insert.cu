// Ragged RGA insert phase over the element-page pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel _ragged_insert_kernel of the reference package
// (ops/ragged_pallas.py): per batch doc i, gather its pages
// page_table[i, 0:page_count[i]] from the (N, P) pool into one contiguous
// window of cap = page_count[i] * P slots, run its first ins_counts[i] ops
// through the step loop of insert_steps.cuh with that window's capacity,
// scatter the window back to the same pages in place, and write n and
// overflow.  Page-table padding (page 0, the null page) is never gathered
// or scattered, and no page outside a doc's table is touched, so the null
// page and every unowned page come back bit-identical.  The trip count is
// the doc's own op count, not the stream width; a carried n past cap is
// flagged before any scan reads the window.
//
// What bounds it on this card: as in insert.cu, the per-step chain of
// dependent block reductions and the shift, separated by barriers; the
// page gather and scatter move each page once each way.  The design: one
// thread block per doc, the window in dynamic shared memory when the
// widest doc's window fits the budget, else (global variant) in a
// contiguous per-doc scratch window in device memory at offsets the
// wrapper takes from a prefix sum of page_count * P, so no shape routes
// away from the kernel.  Every block is sized for the widest doc
// (threads and shared bytes are per launch), which small docs pay for.
//
// Plain C interface, loaded with ctypes (ops/ragged_insert.py).  The launch
// returns its cudaError_t; it never synchronises.

#include <cuda_runtime.h>
#include <cstddef>

#include "insert_steps.cuh"

namespace {

using peritext::insert_steps;
using peritext::kMaxThreads;

template <bool kShared>
__global__ void __launch_bounds__(kMaxThreads) ragged_insert_kernel(
    int* pool_elem, int* pool_char, const int* __restrict__ page_table,
    const int* __restrict__ page_count, const int* __restrict__ ins_counts,
    const int* __restrict__ n_in, const unsigned char* __restrict__ ov_in,
    const int* __restrict__ ins_ref, const int* __restrict__ ins_op,
    const int* __restrict__ ins_char, int* __restrict__ n_out,
    unsigned char* __restrict__ ov_out, int* scratch_elem, int* scratch_char,
    const long long* __restrict__ scratch_offset, int page_size, int gmax,
    int num_ops) {
  extern __shared__ int window[];
  __shared__ int red[2][32];

  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int g = min(max(page_count[i], 0), gmax);
  const int cap = g * page_size;
  const int* table = page_table + static_cast<size_t>(i) * gmax;

  int* elem;
  int* chars;
  if (kShared) {
    elem = window;
    chars = window + gmax * page_size;
  } else {
    elem = scratch_elem + scratch_offset[i];
    chars = scratch_char + scratch_offset[i];
  }
  for (int j = tid; j < cap; j += nthreads) {
    const size_t src =
        static_cast<size_t>(table[j / page_size]) * page_size + j % page_size;
    elem[j] = pool_elem[src];
    chars[j] = pool_char[src];
  }
  int n = n_in[i];
  int ov = ov_in[i] != 0;
  __syncthreads();

  const size_t srow = static_cast<size_t>(i) * num_ops;
  const int count = min(max(ins_counts[i], 0), num_ops);
  insert_steps(elem, chars, n, ov, ins_ref + srow, ins_op + srow,
               ins_char + srow, count, cap, red);
  __syncthreads();

  for (int j = tid; j < cap; j += nthreads) {
    const size_t dst =
        static_cast<size_t>(table[j / page_size]) * page_size + j % page_size;
    pool_elem[dst] = elem[j];
    pool_char[dst] = chars[j];
  }
  if (tid == 0) {
    n_out[i] = n;
    ov_out[i] = static_cast<unsigned char>(ov);
  }
}

}  // namespace

extern "C" int peritext_ragged_insert(
    int* pool_elem, int* pool_char, const int* page_table,
    const int* page_count, const int* ins_counts, const int* n_in,
    const unsigned char* ov_in, const int* ins_ref, const int* ins_op,
    const int* ins_char, int* n_out, unsigned char* ov_out, int* scratch_elem,
    int* scratch_char, const long long* scratch_offset, int num_docs,
    int page_size, int gmax, int num_ops, int use_shared, int threads,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (use_shared) {
    const size_t bytes =
        2 * static_cast<size_t>(gmax) * page_size * sizeof(int);
    cudaError_t err = cudaFuncSetAttribute(
        ragged_insert_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear, and report this one
      return static_cast<int>(err);
    }
    ragged_insert_kernel<true><<<num_docs, threads, bytes, st>>>(
        pool_elem, pool_char, page_table, page_count, ins_counts, n_in, ov_in,
        ins_ref, ins_op, ins_char, n_out, ov_out, scratch_elem, scratch_char,
        scratch_offset, page_size, gmax, num_ops);
  } else {
    ragged_insert_kernel<false><<<num_docs, threads, 0, st>>>(
        pool_elem, pool_char, page_table, page_count, ins_counts, n_in, ov_in,
        ins_ref, ins_op, ins_char, n_out, ov_out, scratch_elem, scratch_char,
        scratch_offset, page_size, gmax, num_ops);
  }
  return static_cast<int>(cudaGetLastError());
}
