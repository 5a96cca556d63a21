// K2, K3, K5's and K6's backward (the rows kernel) at hidden 64, 128 and
// 256: the plain C entry point nkt_fused_render_bwd.  The kernels, their
// design and what bounds them: nerf_rows.cuh; hidden 512 and 1024 are
// fused_render_bwd_512.cu and fused_render_bwd_1024.cu (each library
// compiles apart, in parallel).

#include "nerf_rows.cuh"

NKT_ROWS_ENTRY(nkt_fused_render_bwd, 64, 128, 256)
