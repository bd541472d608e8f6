// Sequential RGA insert phase for a batch of documents, for Hopper (sm_90a).
//
// Replaces the TPU kernels _insert_kernel and _insert_kernel_chunked of the
// reference package (ops/pallas_insert.py): every one of a document's K
// inserts, in order, on its (elem_id, char) rows, on a window of the first
// s_loop slots (the capacity), written to separate output planes.
//
// What bounds it on this card: per step a doc scans its live slots for the
// reference and the skip slot and moves the tail, a chain of dependent
// shared-memory loads; at the main path's shapes that chain, not device
// memory bytes, sets the time.  The design (insert_kernel.cuh,
// insert_steps.cuh): every doc of a call has the same window, so one launch
// with one team -- a warp per doc for windows up to the wrapper's
// threshold, with no block barrier in its step loop and many docs resident
// per SM, else a block per doc -- early-exit ballot scans, and the op
// stream in registers.  A window past the shared-memory budget runs the
// same body on the output rows in device memory.
//
// Plain C interface, loaded with ctypes (ops/insert.py).  Returns the
// launch's cudaError_t; never synchronises.

#include "insert_kernel.cuh"

extern "C" int peritext_insert_batch(
    const int* elem_in, const int* char_in, const int* n_in, const unsigned char* ov_in,
    const int* ins_ref, const int* ins_op, const int* ins_char, int* elem_out,
    int* char_out, int* n_out, unsigned char* ov_out, int num_docs, int slot_capacity,
    int s_loop, int num_ops, int warp_team, int shared, int threads, void* stream) {
  peritext::InsertBatch b{};
  b.num_docs = num_docs;
  b.wcap = s_loop;
  b.n_in = n_in;
  b.ov_in = ov_in;
  b.n_out = n_out;
  b.ov_out = ov_out;
  b.ins_ref = ins_ref;
  b.ins_op = ins_op;
  b.ins_char = ins_char;
  b.num_ops = num_ops;
  b.elem_in = elem_in;
  b.char_in = char_in;
  b.elem_out = elem_out;
  b.char_out = char_out;
  b.slot_capacity = slot_capacity;
  b.s_loop = s_loop;
  return peritext::launch_insert<peritext::Source::kRows>(
      b, warp_team, shared, threads, static_cast<cudaStream_t>(stream));
}
