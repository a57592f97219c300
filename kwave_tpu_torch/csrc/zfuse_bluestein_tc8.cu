// The fused z stage's Bluestein kernel (zfuse_bluestein.cuh) at tiles of 8 columns, a
// source of its own so that nvcc builds it beside the other widths.

#include "zfuse_bluestein.cuh"

int kw_blue::launch_tc8(const kw_blue::Args& a) { return launch_bluestein<8>(a); }
