// The fused z stage's Bluestein kernel (zfuse_bluestein.cuh) at tiles of 2 columns, a
// source of its own so that nvcc builds it beside the other widths.

#include "zfuse_bluestein.cuh"

int kw_blue::launch_tc2(const kw_blue::Args& a) { return launch_bluestein<2>(a); }
