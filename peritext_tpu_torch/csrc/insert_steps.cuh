// The RGA insert step loop, shared by the padded kernel (insert.cu) and the
// ragged one (ragged_insert.cu).
//
// One thread block owns one document's window `elem`/`chars` (in shared or
// device memory) and applies its ops in order.  Each step is the
// reference's applyListInsert (src/micromerge.ts:1187-1245):
//   p  = first slot in [0, n) holding the reference element (HEAD: -1);
//   q  = first slot in (p, n) whose element id is below the op id (else n);
//   the tail [q, n) moves up one slot and slot q takes the new element.
// A missing reference or a full window (n >= cap) sets the overflow flag
// and leaves the doc unchanged; op id 0 is padding and a no-op.  The
// `pos < n` guards are kept: slots past n are never read.

#pragma once

#include <cuda_runtime.h>
#include <climits>

namespace peritext {

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

// The step loop on one doc's window of `cap` slots.  n and ov are updated
// in place (block-uniform).  Every write to the window is followed by a
// block barrier before the loop moves on.
__device__ __forceinline__ void insert_steps(
    int* elem, int* chars, int& n, int& ov, const int* refs, const int* ops,
    const int* chs, int num_ops, int cap, int (*red)[32]) {
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  unsigned r = 0;  // reduction counter: selects red[r & 1]

  for (int k = 0; k < num_ops; ++k) {
    const int op = ops[k];
    if (op == 0) continue;  // padding: not live
    if (n >= cap) {  // window full: flagged whether or not ref exists
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

}  // namespace peritext
