// K2 window_sums and K2t window_sums_tables: the default instantiations of
// the window-sum templates in window_sums.cuh (radix 16, int16 table, int32
// partials, rolled loops, 64 lanes a block), which every verdict path runs.
// With W = 33 windows a block (the port's default, ops/msm.py
// auto_win_chunk) K2 launches a (nchunk, B, 1) grid of 66 threads with
// 94,624 B of shared memory and K2t 128 threads with the same: the
// launch configuration and the additions of the kernels these templates
// were written from.  Only these every-window kernels are here: the
// any-W kernels of the same instantiations, which the windows-per-block
// knob reaches, are in window_sums_w.cu, built at their first launch, so a
// verdict path's first call compiles only what it runs.
//
// K2 replaces: ed25519_consensus_tpu/ops/pallas_msm.py:_compiled_pallas_kernel_rolled
// (the pl.pallas_call at pallas_msm.py:320, default tables_in=False), with
// the nibble unpack of ops/msm.py:expand_digits fused into the digit load.
// K2t replaces the same kernel's tables_in=True form, both tables_batched
// forms (pallas_msm.py:511-587): the tables arrive prebuilt — the resident
// head tables of a recurring keyset and the per-signature R tables K4
// (build_tables.cu) wrote — and the block only copies them.  Bound, design
// and plain versions: window_sums.cuh.  The variants the kernel lab sweeps
// are in window_sums_lab.cu, window_sums_r32.cu and window_sums_hybrid.cu.
#include "window_sums.cuh"

WS_K2(window_sums, ALL, 4, int16_t, int32_t, false, 64)
WS_K2T(window_sums_tables, ALL, k2t_body, int32_t, 4, int16_t, int32_t, 64)
