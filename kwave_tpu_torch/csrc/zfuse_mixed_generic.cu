// The mixed-radix kernel's plans with a generic pass (zfuse_mixed.cuh), a source of its
// own so that nvcc builds it beside zfuse_mixed.cu, with its registers capped for
// kGenericBlocks (2) blocks an SM.

#include "zfuse_mixed.cuh"

extern "C" {

// kw_zfuse_mixed for a plan whose first radix is an odd prime from 17 (that entry calls it).
int kw_zfuse_mixed_generic(KW_MIXED_PARAMS) {
  const int radices[kMaxPasses] = {r0, r1, r2, r3, r4, r5, r6};
  return mixed_entry<true>(KW_MIXED_ARGS, radices, tc, stream);
}

}  // extern "C"
