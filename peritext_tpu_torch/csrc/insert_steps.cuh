// The RGA insert step loops, shared by the padded kernel (insert.cu) and the
// ragged one (ragged_insert.cu) through insert_kernel.cuh.
//
// A team of threads owns one document's window `elem`/`chars` (in shared or
// device memory) and applies its ops in order.  Each step is the
// reference's applyListInsert (src/micromerge.ts:1187-1245):
//   p  = first slot in [0, n) holding the reference element (HEAD: -1);
//   q  = first slot in (p, n) whose element id is below the op id (else n);
//   the tail [q, n) moves up one slot and slot q takes the new element.
// A missing reference or a full window (n >= cap) sets the overflow flag
// and leaves the doc unchanged; op id 0 is padding and a no-op.  Every read
// of the window is guarded by `j < n`: slots past n are never read, and a
// step writes exactly the slots [q, n].
//
// Two teams run the same steps:
// * warp team (warp_insert_steps): one warp per doc, no block barrier.  The
//   scans walk the live range from the left in 32-slot chunks, a
//   __ballot_sync per chunk, and stop at the first hit (__ffs); the shift
//   moves chunks through registers with a __syncwarp between reads and
//   writes.
// * block team (block_insert_steps): a thread block per doc, for long
//   windows.  Warp w scans the rounds of its own chunks; a hit goes into one
//   shared word by atomicMin, every warp stops once that word lies below its
//   round, and one barrier ends the scan.  The shift moves nthreads slots a
//   chunk with a barrier between reads and writes.
// Both first test slot p + 1 for the skip (the common case: the op is newer
// than its right neighbour) and scan only when it fails.
// Both read the op stream 32 ops at a time into registers, one op per lane
// with the next chunk's loads in flight, and take each step's triple out by
// a shuffle, so no global load sits on a step's chain.

#pragma once

#include <cuda_runtime.h>
#include <climits>

namespace peritext {

constexpr int kMaxThreads = 1024;
constexpr unsigned kFullMask = 0xffffffffu;
// 32-slot chunks read together per round of the reference scan (loads in
// flight at once); the skip scan reads one chunk a round, since it almost
// always stops in its first
constexpr int kRefChunks = 4;
// chunks the shift moves per barrier
constexpr int kShiftChunks = 2;

// Apply `step(op, ref, ch)` to ops [0, count) in order.  Lane l holds op
// k0 + l of the current 32-op chunk; the next chunk's loads are issued
// before the current chunk's steps run.  Every lane of the calling warp
// must call it.
template <class Step>
__device__ __forceinline__ void for_each_op(const int* refs, const int* ops, const int* chs,
                                            int count, Step step) {
  const int lane = threadIdx.x & 31;
  int r = 0, o = 0, c = 0;
  if (lane < count) {
    r = refs[lane];
    o = ops[lane];
    c = chs[lane];
  }
  for (int k0 = 0; k0 < count; k0 += 32) {
    const int jn = k0 + 32 + lane;
    int nr = 0, no = 0, nc = 0;
    if (jn < count) {
      nr = refs[jn];
      no = ops[jn];
      nc = chs[jn];
    }
    const int m = min(32, count - k0);
    for (int t = 0; t < m; ++t) {
      step(__shfl_sync(kFullMask, o, t), __shfl_sync(kFullMask, r, t),
           __shfl_sync(kFullMask, c, t));
    }
    r = nr;
    o = no;
    c = nc;
  }
}

// First j in [base, min(base + 32U, n)) with pred(elem[j]), or INT_MAX.
// Warp-uniform result; the U chunks' loads are issued before any ballot.
template <int U, class Pred>
__device__ __forceinline__ int chunk_hit(const int* elem, int base, int n, Pred pred) {
  const int lane = threadIdx.x & 31;
  int v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = base + 32 * u + lane;
    v[u] = j < n ? elem[j] : 0;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = base + 32 * u + lane;
    const unsigned hit = __ballot_sync(kFullMask, j < n && pred(v[u]));
    if (hit) return base + 32 * u + __ffs(hit) - 1;
  }
  return INT_MAX;
}

// ---- warp team --------------------------------------------------------------

// First j in [from, n) with pred(elem[j]), or n.
template <int U, class Pred>
__device__ __forceinline__ int warp_first(const int* elem, int from, int n, Pred pred) {
  for (int base = from; base < n; base += 32 * U) {
    const int hit = chunk_hit<U>(elem, base, n, pred);
    if (hit != INT_MAX) return hit;
  }
  return n;
}

// Move [q, n) up one slot, top chunks first.  A round reads its U chunks,
// syncs the warp, then writes them; rounds touch disjoint slots except the
// one each reads below its range, which the next round writes only after
// its own sync.
template <int U>
__device__ __forceinline__ void warp_shift(int* elem, int* chars, int q, int n) {
  const int lane = threadIdx.x & 31;
  for (int top = n; top > q; top -= 32 * U) {
    int e[U], c[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = top - 32 * u - lane;
      e[u] = c[u] = 0;
      if (j > q) {
        e[u] = elem[j - 1];
        c[u] = chars[j - 1];
      }
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = top - 32 * u - lane;
      if (j > q) {
        elem[j] = e[u];
        chars[j] = c[u];
      }
    }
  }
}

// The step loop of one doc on one warp.  n and ov are updated in place
// (warp-uniform).  The window must be visible to the whole warp on entry.
__device__ __forceinline__ void warp_insert_steps(int* elem, int* chars, int& n, int& ov,
                                                  const int* refs, const int* ops,
                                                  const int* chs, int count, int cap) {
  const int lane = threadIdx.x & 31;
  for_each_op(refs, ops, chs, count, [&](int op, int ref, int ch) {
    if (op == 0) return;  // padding: not live
    if (n >= cap) {       // window full: flagged whether or not ref exists
      ov = 1;
      return;
    }
    int p = -1;
    if (ref != 0) {
      p = warp_first<kRefChunks>(elem, 0, n, [ref](int v) { return v == ref; });
      if (p == n) {  // reference element missing
        ov = 1;
        return;
      }
    }
    // convergence skip: first slot right of p whose id is below op; almost
    // always p + 1 itself, which every lane reads at once
    int q = p + 1;
    if (q < n && !(elem[q] < op)) {
      q = warp_first<1>(elem, q + 1, n, [op](int v) { return v < op; });
    }
    warp_shift<kShiftChunks>(elem, chars, q, n);
    if (lane == 0) {
      elem[q] = op;
      chars[q] = ch;
    }
    __syncwarp();
    n += 1;
  });
}

// ---- block team -------------------------------------------------------------

// Block-wide first j in [from, n) with pred(elem[j]), or n.  `words` are
// three shared words, all INT_MAX before the first scan; scan number r
// (counted by the caller, block-uniform) uses words[r % 3] and, after its
// barrier, thread 0 resets words[(r + 2) % 3]: every thread read that word
// (scan r - 1) before this barrier, and scan r + 2 writes it only after the
// next one.  Warp w walks rounds of U chunks at from + 32U (w + i nwarps)
// and stops at its first hit or once a hit below its round is known; the
// least hit is therefore the first in the range.
template <int U, class Pred>
__device__ __forceinline__ int block_first(const int* elem, int from, int n, Pred pred,
                                           int* words, int r) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  volatile int* word = words + r;
  for (int base = from + 32 * U * warp; base < n; base += blockDim.x * U) {
    if (__shfl_sync(kFullMask, *word, 0) < base) break;
    const int hit = chunk_hit<U>(elem, base, n, pred);
    if (hit != INT_MAX) {
      if (lane == 0) atomicMin(words + r, hit);
      break;
    }
  }
  __syncthreads();
  const int first = *word;
  if (threadIdx.x == 0) words[r == 0 ? 2 : r - 1] = INT_MAX;  // (r + 2) % 3
  return first == INT_MAX ? n : first;
}

// Move [q, n) up one slot, U chunks of nthreads slots per barrier, top
// first; the same disjointness as warp_shift, with block barriers.
template <int U>
__device__ __forceinline__ void block_shift(int* elem, int* chars, int q, int n) {
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  for (int top = n; top > q; top -= nthreads * U) {
    int e[U], c[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = top - nthreads * u - tid;
      e[u] = c[u] = 0;
      if (j > q) {
        e[u] = elem[j - 1];
        c[u] = chars[j - 1];
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = top - nthreads * u - tid;
      if (j > q) {
        elem[j] = e[u];
        chars[j] = c[u];
      }
    }
  }
}

// The step loop of one doc on the whole block.  n and ov are updated in
// place (block-uniform).  `words`: three shared words, INT_MAX, visible to
// the block on entry (block_first).
__device__ __forceinline__ void block_insert_steps(int* elem, int* chars, int& n, int& ov,
                                                   const int* refs, const int* ops,
                                                   const int* chs, int count, int cap,
                                                   int* words) {
  int r = 0;  // scan counter mod 3: selects words[r]
  auto next = [&r]() {
    const int cur = r;
    r = r == 2 ? 0 : r + 1;
    return cur;
  };
  for_each_op(refs, ops, chs, count, [&](int op, int ref, int ch) {
    if (op == 0) return;
    if (n >= cap) {
      ov = 1;
      return;
    }
    int p = -1;
    if (ref != 0) {
      p = block_first<kRefChunks>(elem, 0, n, [ref](int v) { return v == ref; }, words, next());
      if (p == n) {
        ov = 1;
        return;
      }
    }
    // the skip slot is almost always p + 1, which every thread reads at
    // once: no scan, no barrier (the shift's first barrier orders this read
    // before any write)
    int q = p + 1;
    if (q < n && !(elem[q] < op)) {
      q = block_first<1>(elem, q + 1, n, [op](int v) { return v < op; }, words, next());
    }
    block_shift<kShiftChunks>(elem, chars, q, n);
    if (threadIdx.x == 0) {
      elem[q] = op;
      chars[q] = ch;
    }
    n += 1;
    __syncthreads();
  });
}

}  // namespace peritext
