// The mixed-radix kernel's plans of radices in registers alone, and its entry (the kernel
// and its design: zfuse_mixed.cuh; plans with a generic pass: zfuse_mixed_generic.cu and
// zfuse_mixed_generic3.cu).

#include "zfuse_mixed.cuh"

namespace {

// Whether a plan with a generic pass takes the build capped for 3 blocks an SM: two or
// more radix passes after the generic pass, and the tiles of that build's rule let three
// blocks share an SM (else its register cap costs without the third block).
bool generic_on_three(int nz, int n_ops, int n_passes, int p) {
  const int table = generic_table_size(p);
  return n_passes >= 3 && mixed_fits(nz, mixed_tc(nz, n_ops, table, 3), n_ops, table, 3);
}

}  // namespace

extern "C" {

int kw_zfuse_mixed_generic(KW_MIXED_PARAMS);
int kw_zfuse_mixed_generic3(KW_MIXED_PARAMS);

// The mixed-radix kernel: n_passes radices r0.. (the rest ignored), each 2, 3, 4, 5, 7, 8,
// 11, 13 or 16 but r0, which may be an odd prime from 17 (the generic pass, launched from
// zfuse_mixed_generic.cu, or zfuse_mixed_generic3.cu where `generic_on_three`), whose
// product is nz; bins[p] (int16) the bin position p holds
// after the forward passes; tc the tile's columns (32, 16 or 8; 0: mixed_tc's). Returns a
// cudaError (0 = cudaSuccess): of the shared-memory opt-in, or cudaGetLastError() after the
// launch; cudaErrorInvalidValue for any other plan or tile width, or where the tiles do not
// fit a block.
int kw_zfuse_mixed(KW_MIXED_PARAMS) {
  if (!in_registers(r0)) {
    const auto launch = generic_on_three(nz, n_ops, n_passes, r0) ? kw_zfuse_mixed_generic3
                                                                  : kw_zfuse_mixed_generic;
    return launch(KW_MIXED_ARGS, r0, r1, r2, r3, r4, r5, r6, tc, stream);
  }
  const int radices[kMaxPasses] = {r0, r1, r2, r3, r4, r5, r6};
  return mixed_entry<false>(KW_MIXED_ARGS, radices, tc, stream);
}

// The entries (complex64) of the generic pass's table of roots for the prime p, which the
// host's copy (ops.zfuse.generic_table_size) must equal: it decides which z lengths fit.
int kw_zfuse_generic_table_size(int p) { return generic_table_size(p); }

}  // extern "C"
