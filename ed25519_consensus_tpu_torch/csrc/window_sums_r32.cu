// Radix-32 instantiations of the window-sum templates (window_sums.cuh):
// window_bits=5 of ed25519_consensus_tpu/ops/pallas_msm.py:
// _compiled_pallas_kernel_rolled (pallas_msm.py:185-188, table length
// :216; pl.pallas_call at :320).  27 plain int8 digit planes, digits in
// [-16, 15], a 17-entry [0..16]P table of which 16 entries are stored.
//   window_sums_r32          K2, int16 table at 64 lanes: 16 x (80 x 64 + 2)
//                            x 2 B = 164 KB of table, ~174 KB a block with
//                            W = 27, so one block (54 window threads) runs
//                            on an SM at a time;
//   window_sums_r32_i32tbl_c32  K2 with an int32 table, which does not fit
//                            at 64 lanes (~328 KB) and so takes 32;
//   window_sums_tables_r32   K2t on prebuilt 17-entry tables (K4's r32
//                            form, build_tables.cu).
// Against radix 16, cold K2 does 15 x 64 table additions and 27 x 63
// window additions per chunk (7 x 64 and 33 x 63 at radix 16); K2t does
// 18 % fewer additions but copies twice the table bytes.
#include "window_sums.cuh"

WS_K2(window_sums_r32, BOTH, 5, int16_t, int32_t, false, 64)
WS_K2(window_sums_r32_i32tbl_c32, ALL, 5, int32_t, int32_t, false, 32)
WS_K2T(window_sums_tables_r32, ALL, k2t_body, int32_t, 5, int16_t, int32_t, 64)
