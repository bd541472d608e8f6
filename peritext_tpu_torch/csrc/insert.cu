// Sequential RGA insert phase for a batch of documents, for Hopper (sm_90a).
//
// Replaces the TPU kernels _insert_kernel and _insert_kernel_chunked of the
// reference package (ops/pallas_insert.py): every one of a document's K
// inserts, in order, on its (elem_id, char) rows.  Each step is the
// reference's applyListInsert (src/micromerge.ts:1187-1245):
//   p  = first slot in [0, n) holding the reference element (HEAD: -1);
//   q  = first slot in (p, n) whose element id is below the op id (else n);
//   the tail [q, n) moves up one slot and slot q takes the new element.
// A missing reference or a full window (n >= s_loop) sets the overflow flag
// and leaves the doc unchanged; op id 0 is padding and a no-op.  The
// `pos < n` guards are kept: slots past n are never read.
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
#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// Block-wide minimum.  `red` alternates between two buffers by the caller's
// reduction counter, so a fast warp writing the next reduction's word can
// never overwrite a word a slow warp is still reading.
__device__ __forceinline__ int block_min(int v, int* red, int nwarps) {
  v = warp_min(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int out = INT_MAX;
  for (int w = 0; w < nwarps; ++w) out = min(out, red[w]);
  return out;
}

// The K-step loop on one doc's window `elem`/`chars` (shared or device
// memory).  Returns nothing; n and ov are updated in place (block-uniform).
__device__ __forceinline__ void insert_steps(
    int* elem, int* chars, int& n, int& ov, const int* refs, const int* ops,
    const int* chs, int num_ops, int s_loop, int (*red)[32]) {
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  unsigned r = 0;  // reduction counter: selects red[r & 1]

  for (int k = 0; k < num_ops; ++k) {
    const int op = ops[k];
    if (op == 0) continue;  // padding: not live
    if (n >= s_loop) {  // window full: flagged whether or not ref exists
      ov = 1;
      continue;
    }
    const int ref = refs[k];

    int p = -1;
    if (ref != 0) {
      int first = INT_MAX;
      for (int j = tid; j < n; j += nthreads) {
        if (elem[j] == ref) {
          first = j;
          break;
        }
      }
      first = block_min(first, red[r++ & 1], nwarps);
      if (first == INT_MAX) {  // reference element missing
        ov = 1;
        continue;
      }
      p = first;
    }

    // Convergence skip: first slot right of p whose id is below op.
    int first = INT_MAX;
    for (int j = p + 1 + tid; j < n; j += nthreads) {
      if (elem[j] < op) {
        first = j;
        break;
      }
    }
    first = block_min(first, red[r++ & 1], nwarps);
    const int q = first == INT_MAX ? n : first;

    // Shift [q, n) up one slot, top chunk first.  Each chunk reads before
    // the barrier and writes after it; chunks touch disjoint slots except
    // the one each reads below its range, which the next chunk writes only
    // after its own barrier.
    for (int base = n; base > q; base -= nthreads) {
      const int j = base - tid;
      const bool mv = j > q;
      int e = 0, c = 0;
      if (mv) {
        e = elem[j - 1];
        c = chars[j - 1];
      }
      __syncthreads();
      if (mv) {
        elem[j] = e;
        chars[j] = c;
      }
    }
    if (tid == 0) {
      elem[q] = op;
      chars[q] = chs[k];
    }
    n += 1;
    __syncthreads();
  }
}

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
