// The one RGA insert kernel body and its launch, for Hopper (sm_90a), shared
// by the padded entry (insert.cu) and the ragged one (ragged_insert.cu).
//
// A launch serves one doc class: `num_docs` docs, rows[i] the batch row of
// the i-th (or i itself), every window at most `wcap` slots.  Per doc the
// kernel fills its window from the source, runs its ops with a team's step
// loop (insert_steps.cuh), and writes the window back:
// * Source::kRows (padded, K1/K2): the window is the first s_loop slots of
//   row `row` of (D, S) planes, read from the input planes and written to
//   separate output planes; slots past s_loop are copied through.  Every
//   doc runs all num_ops stream entries.
// * Source::kPages (ragged, K3): the window is the doc's pages
//   page_table[row, 0:page_count[row]] of the (N, P) pool, gathered and
//   scattered back in place; page-table padding is never touched.  The doc
//   runs its first ins_counts[row] entries.
// Team: a warp per doc (kWarpTeam; blockDim.x / 32 docs a block), or the
// whole block per doc.  Window: dynamic shared memory (kShared; wcap slots
// per plane for each doc of the block), else device memory: the output row
// itself (kRows) or a scratch window at scratch_offset[row] (kPages).

#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <cstddef>

#include "insert_steps.cuh"

namespace peritext {

enum class Source { kRows, kPages };

struct InsertBatch {
  // the launch's docs
  const int* rows;  // batch row of each doc; nullptr: doc i is row i
  int num_docs;
  int wcap;  // widest window of the class, slots
  // per batch row
  const int* n_in;
  const unsigned char* ov_in;
  int* n_out;
  unsigned char* ov_out;
  const int* ins_ref;
  const int* ins_op;
  const int* ins_char;
  int num_ops;            // stream width
  const int* ins_counts;  // ops each row runs; nullptr: num_ops
  // Source::kRows
  const int* elem_in;
  const int* char_in;
  int* elem_out;
  int* char_out;
  int slot_capacity;
  int s_loop;
  // Source::kPages
  int* pool_elem;
  int* pool_char;
  const int* page_table;
  const int* page_count;
  int page_size;
  int gmax;
  int* scratch_elem;
  int* scratch_char;
  const long long* scratch_offset;
};

template <bool kWarpTeam>
__device__ __forceinline__ void team_sync() {
  if (kWarpTeam) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

template <Source kSrc, bool kShared, bool kWarpTeam>
__global__ void __launch_bounds__(kMaxThreads) insert_kernel(const InsertBatch b) {
  extern __shared__ int window[];
  __shared__ int words[3];

  const int team = kWarpTeam ? 32 : blockDim.x;
  const int t = kWarpTeam ? (threadIdx.x & 31) : threadIdx.x;
  const int slot = kWarpTeam ? (threadIdx.x >> 5) : 0;  // the doc's place in the block
  const int i = kWarpTeam ? blockIdx.x * (blockDim.x >> 5) + slot : blockIdx.x;
  if (i >= b.num_docs) return;  // whole warps of a block's last, partial group
  const int row = b.rows ? b.rows[i] : i;

  const int cap = kSrc == Source::kRows
                      ? b.s_loop
                      : min(max(b.page_count[row], 0), b.gmax) * b.page_size;
  const size_t base = static_cast<size_t>(row) * b.slot_capacity;  // kRows only
  const int* table =
      kSrc == Source::kPages ? b.page_table + static_cast<size_t>(row) * b.gmax : nullptr;
  int* elem;
  int* chars;
  if (kShared) {
    elem = window + 2 * static_cast<size_t>(b.wcap) * slot;
    chars = elem + b.wcap;
  } else if (kSrc == Source::kRows) {
    elem = b.elem_out + base;
    chars = b.char_out + base;
  } else {
    elem = b.scratch_elem + b.scratch_offset[row];
    chars = b.scratch_char + b.scratch_offset[row];
  }

  if (kSrc == Source::kRows) {
    if (kShared) {
      for (int j = t; j < b.s_loop; j += team) {
        elem[j] = b.elem_in[base + j];
        chars[j] = b.char_in[base + j];
      }
    }
    // the global variant's window is the output row: copy all of it;
    // otherwise only the slots past the window, which no step touches
    for (int j = (kShared ? b.s_loop : 0) + t; j < b.slot_capacity; j += team) {
      b.elem_out[base + j] = b.elem_in[base + j];
      b.char_out[base + j] = b.char_in[base + j];
    }
  } else {
    for (int j = t; j < cap; j += team) {
      const size_t src = static_cast<size_t>(table[j / b.page_size]) * b.page_size +
                         j % b.page_size;
      elem[j] = b.pool_elem[src];
      chars[j] = b.pool_char[src];
    }
  }
  int n = b.n_in[row];
  int ov = b.ov_in[row] != 0;
  if (!kWarpTeam && threadIdx.x < 3) words[threadIdx.x] = INT_MAX;
  team_sync<kWarpTeam>();

  const size_t srow = static_cast<size_t>(row) * b.num_ops;
  const int count = b.ins_counts ? min(max(b.ins_counts[row], 0), b.num_ops) : b.num_ops;
  if (kWarpTeam) {
    warp_insert_steps(elem, chars, n, ov, b.ins_ref + srow, b.ins_op + srow, b.ins_char + srow,
                      count, cap);
  } else {
    block_insert_steps(elem, chars, n, ov, b.ins_ref + srow, b.ins_op + srow,
                       b.ins_char + srow, count, cap, words);
  }
  team_sync<kWarpTeam>();

  if (kSrc == Source::kRows) {
    if (kShared) {
      for (int j = t; j < b.s_loop; j += team) {
        b.elem_out[base + j] = elem[j];
        b.char_out[base + j] = chars[j];
      }
    }
  } else {
    for (int j = t; j < cap; j += team) {
      const size_t dst = static_cast<size_t>(table[j / b.page_size]) * b.page_size +
                         j % b.page_size;
      b.pool_elem[dst] = elem[j];
      b.pool_char[dst] = chars[j];
    }
  }
  if (t == 0) {
    b.n_out[row] = n;
    b.ov_out[row] = static_cast<unsigned char>(ov);
  }
}

// Launch one doc class on `stream`: a warp per doc and threads / 32 docs a
// block (warp_team), else a block of `threads` per doc; windows in shared
// memory (shared) or device memory.  Returns the cudaError_t of the launch
// (a refused shared-memory size included); never synchronises.
template <Source kSrc>
int launch_insert(const InsertBatch& b, int warp_team, int shared, int threads,
                  cudaStream_t stream) {
  if (b.num_docs <= 0) return 0;
  const int per_block = warp_team ? threads / 32 : 1;
  const int blocks = (b.num_docs + per_block - 1) / per_block;
  const size_t bytes = shared ? 2 * static_cast<size_t>(b.wcap) * sizeof(int) * per_block : 0;
  void (*kernel)(InsertBatch) =
      warp_team ? (shared ? &insert_kernel<kSrc, true, true> : &insert_kernel<kSrc, false, true>)
                : (shared ? &insert_kernel<kSrc, true, false> : &insert_kernel<kSrc, false, false>);
  if (shared) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear, and report this one
      return static_cast<int>(err);
    }
  }
  kernel<<<blocks, threads, bytes, stream>>>(b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace peritext
