// The any-W kernels of the lab's window_sums-l20 and window_sums_tables-l20
// (W windows a block, a launch argument): the forms ED25519_TPU_WIN_CHUNK
// reaches on the verdict paths (ops/msm.py auto_win_chunk) and the kernel
// lab's windows-per-block forms (the Pallas kernel's win_chunk,
// ed25519_consensus_tpu/ops/pallas_msm.py:164, :217-218, grid :322).  The
// same instantiations as window_sums_lab.cu's, whose every-window kernels
// the lab times beside the default K2 and K2t; the C entries have the
// same names, and each source builds into a library of its own
// (ops/_cuda.py W_SOURCES).  Bound, design and plain versions:
// window_sums.cuh.
#include "window_sums.cuh"

WS_K2(window_sums_l20, W, 4, int16_t, int32_t, false, 64)
WS_K2T(window_sums_tables_l20, W, k2t_body, int32_t, 4, int16_t, int32_t, 64)
