// K2 window_sums and K2t window_sums_tables, the window-sum kernels every
// verdict path runs: the instantiations of window_sums_u32.cuh (8 x 32-bit
// field arithmetic with carry chains, 160 threads and 67,648 B of shared
// memory a block, 3 blocks an SM, canonical limbs out).  A (nchunk, B)
// grid of one 64-lane chunk a block, every window in one block: the C
// entries refuse any other W, and the windows-per-block knob reaches the
// 20-limb kernels instead (the -l20 forms, window_sums_w.cu).
//
// K2 replaces: ed25519_consensus_tpu/ops/pallas_msm.py:_compiled_pallas_kernel_rolled
// (the pl.pallas_call at pallas_msm.py:320, default tables_in=False), with
// the nibble unpack of ops/msm.py:expand_digits fused into the digit load.
// K2t replaces the same kernel's tables_in=True form, both tables_batched
// forms (pallas_msm.py:511-587): the tables arrive prebuilt — the resident
// head tables of a recurring keyset and the per-signature R tables K4
// (build_tables.cu) wrote — and the block only copies them.  Bound, design
// and plain versions: window_sums_u32.cuh.  The 20-limb kernels these
// replaced, the lab's `window_sums-l20` and `window_sums_tables-l20`, are
// in window_sums_lab.cu; the other variants the kernel lab sweeps in
// window_sums_lab.cu, window_sums_r32.cu and window_sums_hybrid.cu.
#include "window_sums_u32.cuh"

WS_K2_U32(window_sums)
WS_K2T_U32(window_sums_tables)
