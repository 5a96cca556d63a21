// K2, K3, K5's and K6's backward (the rows kernel) at hidden 512: the
// plain C entry point nkt_fused_render_bwd_512 (nerf_rows.cuh).

#include "nerf_rows.cuh"

NKT_ROWS_ENTRY(nkt_fused_render_bwd_512, 512)
