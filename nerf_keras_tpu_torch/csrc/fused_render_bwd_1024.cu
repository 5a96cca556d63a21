// K2, K3, K5's and K6's backward (the rows kernel) at hidden 1024: the
// plain C entry point nkt_fused_render_bwd_1024 (nerf_rows.cuh).

#include "nerf_rows.cuh"

NKT_ROWS_ENTRY(nkt_fused_render_bwd_1024, 1024)
