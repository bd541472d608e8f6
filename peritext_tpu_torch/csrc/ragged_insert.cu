// Ragged RGA insert phase over the element-page pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel _ragged_insert_kernel of the reference package
// (ops/ragged_pallas.py): per batch doc i, gather its pages
// page_table[i, 0:page_count[i]] from the (N, P) pool into one contiguous
// window of cap = page_count[i] * P slots, run its first ins_counts[i] ops
// with that window's capacity, scatter the window back to the same pages in
// place, and write n and overflow.  Page-table padding (page 0, the null
// page) is never gathered or scattered, and no page outside a doc's table
// is touched, so the null page and every unowned page come back
// bit-identical.  A carried n past cap is flagged before any scan reads the
// window.
//
// What bounds it on this card: as in insert.cu, the per-step chain of
// dependent window loads; the page gather and scatter move each page once
// each way.  The design (insert_kernel.cuh, insert_steps.cuh): the wrapper
// splits the batch by each doc's true window into a warp class (a warp per
// doc, many docs per block and per SM) and a block class (a block per doc,
// threads for the class's widest window), one launch per non-empty class;
// the window lives in shared memory when the class's widest fits the
// budget, else in a per-doc device-memory scratch window.
//
// Plain C interface, loaded with ctypes (ops/ragged_insert.py).  Returns
// the launch's cudaError_t; never synchronises.

#include "insert_kernel.cuh"

extern "C" int peritext_ragged_insert(
    int* pool_elem, int* pool_char, const int* page_table, const int* page_count,
    const int* ins_counts, const int* n_in, const unsigned char* ov_in, const int* ins_ref,
    const int* ins_op, const int* ins_char, int* n_out, unsigned char* ov_out,
    int* scratch_elem, int* scratch_char, const long long* scratch_offset, const int* rows,
    int num_docs, int wcap, int page_size, int gmax, int num_ops, int warp_team, int shared,
    int threads, void* stream) {
  peritext::InsertBatch b{};
  b.rows = rows;
  b.num_docs = num_docs;
  b.wcap = wcap;
  b.n_in = n_in;
  b.ov_in = ov_in;
  b.n_out = n_out;
  b.ov_out = ov_out;
  b.ins_ref = ins_ref;
  b.ins_op = ins_op;
  b.ins_char = ins_char;
  b.num_ops = num_ops;
  b.ins_counts = ins_counts;
  b.pool_elem = pool_elem;
  b.pool_char = pool_char;
  b.page_table = page_table;
  b.page_count = page_count;
  b.page_size = page_size;
  b.gmax = gmax;
  b.scratch_elem = scratch_elem;
  b.scratch_char = scratch_char;
  b.scratch_offset = scratch_offset;
  return peritext::launch_insert<peritext::Source::kPages>(
      b, warp_team, shared, threads, static_cast<cudaStream_t>(stream));
}
