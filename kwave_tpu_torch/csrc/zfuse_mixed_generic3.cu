// The mixed-radix kernel's plans with a generic pass (zfuse_mixed.cuh), its registers
// capped for 3 blocks an SM, for the plans kw_zfuse_mixed sends here (`generic_on_three`):
// a source of its own beside zfuse_mixed_generic.cu.

#define KW_GENERIC_BLOCKS 3
#include "zfuse_mixed.cuh"

extern "C" {

// kw_zfuse_mixed for such a plan (that entry calls it).
int kw_zfuse_mixed_generic3(KW_MIXED_PARAMS) {
  const int radices[kMaxPasses] = {r0, r1, r2, r3, r4, r5, r6};
  return mixed_entry<true>(KW_MIXED_ARGS, radices, tc, stream);
}

}  // extern "C"
