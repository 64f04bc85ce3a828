// The `hybrid` body of the window-sum templates (window_sums.cuh): K2 with
// the window phase's lane loop (31 complete additions a thread) and the
// table build's entry loop fully unrolled — the unroll_windows form of
// ed25519_consensus_tpu/ops/pallas_msm.py:_compiled_pallas_kernel_rolled
// (pallas_msm.py:178-184, :233-242, :269-272; selected by
// ED25519_TPU_PALLAS_BODY at :342-363; pl.pallas_call at :320).  The same
// additions in the same order as the rolled body, so the same limbs.  The
// rolled K2 sits at 253 registers a thread: ptxas's report for this
// instantiation (chip_smoke.py prints it) shows whether unrolling spills.
// In its own source so that its longer compile runs beside the others.
#include "window_sums.cuh"

WS_K2(window_sums_hybrid, BOTH, 4, int16_t, int32_t, true, 64)
