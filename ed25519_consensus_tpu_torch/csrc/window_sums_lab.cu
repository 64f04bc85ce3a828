// Radix-16 variants of the window-sum templates (window_sums.cuh) that the
// kernel lab sweeps (ed25519_consensus_tpu_torch/tools/kernel_lab.py) and
// the stage profile times (tools/microbench.py):
//   window_sums_l20         K2 as first ported, the default K2 until the
//   window_sums_tables_l20  Hopper kernels of window_sums_u32.cuh (20 x
//                           13-bit limbs, 66 threads and 94,624 B a block,
//                           two half-chunk sums): timed beside them in
//                           one call, every window in one block or W
//                           a block (the lab's win_chunk forms, the
//                           Pallas kernel's win_chunk,
//                           pallas_msm.py:164, :217-218, grid :322);
//   window_sums_i16fold     int16 partials and exchange (fold_dtype="int16",
//                           pallas_msm.py:189-193, :254-266);
//   window_sums_i32tbl      the shared table as int32 (tbl_dtype="int32",
//                           pallas_msm.py:162, :215, scratch :318);
//   window_sums_i32tbl_c32  the same at 32 lanes a block (the 2048-lane
//                           tile of the JAX lab's int32-table escape);
//   window_select_only      K2s, the select-only form of K2t
//                           (select_only, pallas_msm.py:200-204, :251-253):
//                           profile only, never on a verdict path.
// Each replaces a form of ed25519_consensus_tpu/ops/pallas_msm.py:
// _compiled_pallas_kernel_rolled (pl.pallas_call at :320).  Windows per
// block (win_chunk) is a launch argument of every instantiation.
#include "window_sums.cuh"

WS_K2(window_sums_l20, BOTH, 4, int16_t, int32_t, false, 64)
WS_K2T(window_sums_tables_l20, BOTH, k2t_body, int32_t, 4, int16_t, int32_t, 64)
WS_K2(window_sums_i16fold, W, 4, int16_t, int16_t, false, 64)
WS_K2(window_sums_i32tbl, ALL, 4, int32_t, int32_t, false, 64)
WS_K2(window_sums_i32tbl_c32, ALL, 4, int32_t, int32_t, false, 32)
WS_K2T(window_select_only, ALL, k2s_body, int32_t, 4, int16_t, int32_t, 64)
