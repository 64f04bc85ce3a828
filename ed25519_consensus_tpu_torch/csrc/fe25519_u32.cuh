// GF(2^255 - 19) and complete Edwards25519 addition on 8 x 32-bit words
// with PTX carry chains: the field arithmetic of K1 (expand_compressed.cu,
// squarings by fe8_sq), K2 and K2t (window_sums_u32.cuh), K3
// (fold_partials.cu), K4 (build_tables.cu) and K7 (shift128_lanes.cu).
// csrc/fe25519.cuh, the 20 x 13-bit balanced-limb arithmetic carried over
// from the TPU (no 64-bit multiply, no carry flag on a VPU lane), stays
// for K5, K6 and the lab's -l20 and -r32 forms.
//
// A Hopper thread is a scalar machine with a carry flag: a full 256 x 256
// product is 64 32 x 32 -> 64-bit multiplies whose halves add into the
// result words in carry chains (add.cc / addc.cc), and 2^256 = 38 (mod p)
// reduces it in ~36 more operations.  ops/fe_u32.py models every function
// here instruction for instruction on Python ints (tests/test_torch_fe_u32.py
// holds it against Python ints mod p; the card's self-test kernel
// probe_fe8 in probes.cu against the model, word for word).
//
// Representation: 8 uint32_t words, least significant first, a value
// below 2^256 ("weak": p < 2^256, so a residue can have two
// representatives).  Every operation takes and returns the weak form.
//
// Closure note (why no carry is lost; the model asserts each claim):
//  * fe8_add: a, b < 2^256, a + b < 2^257: the chain's carry c stands for
//    2^256 = 38, added back by a second chain; if that one carries, the
//    value is now below 38, so word 0 takes the last 38 without a carry.
//  * fe8_sub: a borrow means the pattern is a - b + 2^256; subtracting 38
//    makes it a - b + 2p.  A second borrow (pattern < 38) adds 2p again,
//    and then the pattern is >= 2^256 - 38, so word 0 gives up the last 38
//    without a borrow.  Result a - b + k 2p, k in {0, 1, 2}: never below
//    0.  fe8_neg is fe8_sub from 0.
//  * fe8_mul: after row i the partial product a[0..i] b < 2^(32(i + 9))
//    fits words 0..i+8, so the high-half chain's last word carries out 0
//    (no .cc on it).  L + 38 H <= 39 (2^256 - 1): the top word t <= 38;
//    38 t <= 1444 added by a chain; if that carries, the value is below
//    1444 and word 0 takes 38 more.
//  * fe8_sq: the cross products by rows as fe8_mul's (after row i the
//    partial sum is below a[0..i] a < 2^(32(i + 9))); their sum C <
//    2^480 doubled carries into word 15; C + C + the squares = a^2 <
//    2^512, so the squares' chain carries out 0; then fe8_mul's reduction.
//  * fe8_from_limbs20: |limb| <= 8191 gives |V| < 2^260; the signed
//    64-bit accumulator holds at most 3 limbs shifted by <= 29 bits plus
//    a carry, below 2^44.  q = V >> 255 in [-32, 31]; low255 + 19q lies in
//    [-608, 2^255 + 589): added with its sign extended, a negative total
//    wraps to 2^256 + V' = V' + 38 (mod p), so the wrap (the chain's carry
//    word) subtracts 38, leaving V' + 2p >= 2^256 - 646, no borrow.
//  * fe8_to_limbs20_canonical: folding bit 255 as 19 leaves x < 2^255 + 19
//    < 2p; x >= p exactly when x + 19 sets bit 255, and then x - p = x + 19
//    - 2^255 < 38.  The 13-bit fields of x < p, then the balanced split
//    c = (u + 4096) >> 13 carried serially: limbs 0..18 in [-4096, 4095],
//    limb 19 <= 256.
//
// fe8_mul scans operands (row by row), not products (column by column):
// a row adds 8 low halves and 8 high halves in two chains (17 additions
// for 8 products), where a column accumulator needs three carried
// additions for every product (24 for 8).  The products are mul.wide.u32
// (one 64-bit IMAD.WIDE each), outside the chains: a form with the
// multiplies fused into the chains (mad.lo.cc / madc.hi.cc) compiles each
// to an IMAD or IMAD.HI plus an IADD3.X and ran K2 and K2t slower on an
// H100 (PERF.md, Findings), so it is not kept.
//
// Every carry chain sits inside ONE asm statement: the carry flag does not
// survive between two statements (the compiler may put its own flag-
// setting instructions between them).  No asm is volatile, so ptxas may
// schedule around them.
//
// Tensor cores are not used: every field product in a complete addition
// multiplies two lane-specific operands (the coordinates of this lane's
// accumulator and of its selected table entry), so wgmma / IMMA would have
// no matrix operand shared across lanes.  The one exception, T1 * 2d, is
// one product in nine.
//
// Integer-only: no float type appears on the device path.
#pragma once
#include <stdint.h>

struct fe8 {
  uint32_t v[8];
};

struct ge8 {
  fe8 X, Y, Z, T;
};

// 2d mod p, least significant word first (ops/fe_u32.py D2_WORDS).
__device__ __constant__ uint32_t FE8_D2[8] = {
    0x26b2f159u, 0xebd69b94u, 0x8283b156u, 0x00e0149au,
    0xeef3d130u, 0x198e80f2u, 0x56dffce7u, 0x2406d9dcu};

__device__ __forceinline__ fe8 fe8_add(const fe8& a, const fe8& b) {
  fe8 r;
  uint32_t c;
  asm("add.cc.u32 %0, %9, %17;\n\t"
      "addc.cc.u32 %1, %10, %18;\n\t"
      "addc.cc.u32 %2, %11, %19;\n\t"
      "addc.cc.u32 %3, %12, %20;\n\t"
      "addc.cc.u32 %4, %13, %21;\n\t"
      "addc.cc.u32 %5, %14, %22;\n\t"
      "addc.cc.u32 %6, %15, %23;\n\t"
      "addc.cc.u32 %7, %16, %24;\n\t"
      "addc.u32 %8, 0, 0;"
      : "=r"(r.v[0]), "=r"(r.v[1]), "=r"(r.v[2]), "=r"(r.v[3]),
        "=r"(r.v[4]), "=r"(r.v[5]), "=r"(r.v[6]), "=r"(r.v[7]), "=r"(c)
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]),
        "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]),
        "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]),
        "r"(b.v[7]));
  const uint32_t t = c * 38u;
  asm("add.cc.u32 %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, 0;\n\t"
      "addc.cc.u32 %2, %2, 0;\n\t"
      "addc.cc.u32 %3, %3, 0;\n\t"
      "addc.cc.u32 %4, %4, 0;\n\t"
      "addc.cc.u32 %5, %5, 0;\n\t"
      "addc.cc.u32 %6, %6, 0;\n\t"
      "addc.cc.u32 %7, %7, 0;\n\t"
      "addc.u32 %8, 0, 0;"
      : "+r"(r.v[0]), "+r"(r.v[1]), "+r"(r.v[2]), "+r"(r.v[3]),
        "+r"(r.v[4]), "+r"(r.v[5]), "+r"(r.v[6]), "+r"(r.v[7]), "=r"(c)
      : "r"(t));
  r.v[0] += c * 38u;
  return r;
}

__device__ __forceinline__ fe8 fe8_sub(const fe8& a, const fe8& b) {
  fe8 r;
  uint32_t bw;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=r"(r.v[0]), "=r"(r.v[1]), "=r"(r.v[2]), "=r"(r.v[3]),
        "=r"(r.v[4]), "=r"(r.v[5]), "=r"(r.v[6]), "=r"(r.v[7]), "=r"(bw)
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]),
        "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]),
        "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]),
        "r"(b.v[7]));
  const uint32_t t = bw & 38u;
  asm("sub.cc.u32 %0, %0, %9;\n\t"
      "subc.cc.u32 %1, %1, 0;\n\t"
      "subc.cc.u32 %2, %2, 0;\n\t"
      "subc.cc.u32 %3, %3, 0;\n\t"
      "subc.cc.u32 %4, %4, 0;\n\t"
      "subc.cc.u32 %5, %5, 0;\n\t"
      "subc.cc.u32 %6, %6, 0;\n\t"
      "subc.cc.u32 %7, %7, 0;\n\t"
      "subc.u32 %8, 0, 0;"
      : "+r"(r.v[0]), "+r"(r.v[1]), "+r"(r.v[2]), "+r"(r.v[3]),
        "+r"(r.v[4]), "+r"(r.v[5]), "+r"(r.v[6]), "+r"(r.v[7]), "=r"(bw)
      : "r"(t));
  r.v[0] -= bw & 38u;
  return r;
}

__device__ __forceinline__ fe8 fe8_neg(const fe8& a) {
  fe8 z;
#pragma unroll
  for (int i = 0; i < 8; ++i) z.v[i] = 0u;
  return fe8_sub(z, a);
}

// fe8_mul is inlined by default; -DFE8_MUL_NOINLINE makes it out of line
// (one copy a kernel) for comparing ptxas's register and spill reports
// (tools/ptxas_report.py).
#ifdef FE8_MUL_NOINLINE
#define FE8_MUL_INLINE __noinline__
#else
#define FE8_MUL_INLINE __forceinline__
#endif

// The 64 partial products as 32 x 32 -> 64-bit multiplies (mul.wide.u32)
// outside the chains, which only add: row 0's low and high halves in one
// chain; for rows 1..7, the low halves into words i..i+7 (the carry into
// i+8), then the high halves into i+1..i+8; then L + 38 H as below.
__device__ __forceinline__ void fe8_wide_row(const fe8& b, uint32_t ai,
                                             uint32_t* lo, uint32_t* hi) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint64_t p = (uint64_t)ai * b.v[j];
    lo[j] = (uint32_t)p;
    hi[j] = (uint32_t)(p >> 32);
  }
}

// The 16-word product r (below 2^512) reduced to the weak form, L + 38 H:
// the 38 H_j as 64-bit products, low halves with the carry into the top
// word t, then the high halves one word up, the last into t; then 38 t
// added by a chain and its carry's 38 into word 0.  fe8_mul's and
// fe8_sq's tail.
__device__ __forceinline__ fe8 fe8_reduce_wide(uint32_t* r) {
  uint32_t lo[8], hi[8];
  fe8 h;
#pragma unroll
  for (int j = 0; j < 8; ++j) h.v[j] = r[8 + j];
  fe8_wide_row(h, 38u, lo, hi);
  uint32_t t;
  asm("add.cc.u32 %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, %10;\n\t"
      "addc.cc.u32 %2, %2, %11;\n\t"
      "addc.cc.u32 %3, %3, %12;\n\t"
      "addc.cc.u32 %4, %4, %13;\n\t"
      "addc.cc.u32 %5, %5, %14;\n\t"
      "addc.cc.u32 %6, %6, %15;\n\t"
      "addc.cc.u32 %7, %7, %16;\n\t"
      "addc.u32 %8, 0, 0;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]),
        "+r"(r[5]), "+r"(r[6]), "+r"(r[7]), "=r"(t)
      : "r"(lo[0]), "r"(lo[1]), "r"(lo[2]), "r"(lo[3]), "r"(lo[4]),
        "r"(lo[5]), "r"(lo[6]), "r"(lo[7]));
  asm("add.cc.u32 %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32 %7, %7, %15;"
      : "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]), "+r"(r[5]),
        "+r"(r[6]), "+r"(r[7]), "+r"(t)
      : "r"(hi[0]), "r"(hi[1]), "r"(hi[2]), "r"(hi[3]), "r"(hi[4]),
        "r"(hi[5]), "r"(hi[6]), "r"(hi[7]));
  const uint32_t t38 = t * 38u;
  fe8 o;
  uint32_t c;
  asm("add.cc.u32 %0, %9, %17;\n\t"
      "addc.cc.u32 %1, %10, 0;\n\t"
      "addc.cc.u32 %2, %11, 0;\n\t"
      "addc.cc.u32 %3, %12, 0;\n\t"
      "addc.cc.u32 %4, %13, 0;\n\t"
      "addc.cc.u32 %5, %14, 0;\n\t"
      "addc.cc.u32 %6, %15, 0;\n\t"
      "addc.cc.u32 %7, %16, 0;\n\t"
      "addc.u32 %8, 0, 0;"
      : "=r"(o.v[0]), "=r"(o.v[1]), "=r"(o.v[2]), "=r"(o.v[3]),
        "=r"(o.v[4]), "=r"(o.v[5]), "=r"(o.v[6]), "=r"(o.v[7]), "=r"(c)
      : "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]), "r"(r[4]), "r"(r[5]),
        "r"(r[6]), "r"(r[7]), "r"(t38));
  o.v[0] += c * 38u;
  return o;
}

__device__ FE8_MUL_INLINE fe8 fe8_mul(const fe8& a, const fe8& b) {
  uint32_t r[16], lo[8], hi[8];
  fe8_wide_row(b, a.v[0], lo, hi);
  r[0] = lo[0];
  asm("add.cc.u32 %0, %8, %9;\n\t"
      "addc.cc.u32 %1, %10, %11;\n\t"
      "addc.cc.u32 %2, %12, %13;\n\t"
      "addc.cc.u32 %3, %14, %15;\n\t"
      "addc.cc.u32 %4, %16, %17;\n\t"
      "addc.cc.u32 %5, %18, %19;\n\t"
      "addc.cc.u32 %6, %20, %21;\n\t"
      "addc.u32 %7, %22, 0;"
      : "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]), "=r"(r[5]),
        "=r"(r[6]), "=r"(r[7]), "=r"(r[8])
      : "r"(lo[1]), "r"(hi[0]), "r"(lo[2]), "r"(hi[1]), "r"(lo[3]),
        "r"(hi[2]), "r"(lo[4]), "r"(hi[3]), "r"(lo[5]), "r"(hi[4]),
        "r"(lo[6]), "r"(hi[5]), "r"(lo[7]), "r"(hi[6]), "r"(hi[7]));
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    fe8_wide_row(b, a.v[i], lo, hi);
    asm("add.cc.u32 %0, %0, %9;\n\t"
        "addc.cc.u32 %1, %1, %10;\n\t"
        "addc.cc.u32 %2, %2, %11;\n\t"
        "addc.cc.u32 %3, %3, %12;\n\t"
        "addc.cc.u32 %4, %4, %13;\n\t"
        "addc.cc.u32 %5, %5, %14;\n\t"
        "addc.cc.u32 %6, %6, %15;\n\t"
        "addc.cc.u32 %7, %7, %16;\n\t"
        "addc.u32 %8, 0, 0;"
        : "+r"(r[i]), "+r"(r[i + 1]), "+r"(r[i + 2]), "+r"(r[i + 3]),
          "+r"(r[i + 4]), "+r"(r[i + 5]), "+r"(r[i + 6]), "+r"(r[i + 7]),
          "=r"(r[i + 8])
        : "r"(lo[0]), "r"(lo[1]), "r"(lo[2]), "r"(lo[3]), "r"(lo[4]),
          "r"(lo[5]), "r"(lo[6]), "r"(lo[7]));
    asm("add.cc.u32 %0, %0, %8;\n\t"
        "addc.cc.u32 %1, %1, %9;\n\t"
        "addc.cc.u32 %2, %2, %10;\n\t"
        "addc.cc.u32 %3, %3, %11;\n\t"
        "addc.cc.u32 %4, %4, %12;\n\t"
        "addc.cc.u32 %5, %5, %13;\n\t"
        "addc.cc.u32 %6, %6, %14;\n\t"
        "addc.u32 %7, %7, %15;"
        : "+r"(r[i + 1]), "+r"(r[i + 2]), "+r"(r[i + 3]), "+r"(r[i + 4]),
          "+r"(r[i + 5]), "+r"(r[i + 6]), "+r"(r[i + 7]), "+r"(r[i + 8])
        : "r"(hi[0]), "r"(hi[1]), "r"(hi[2]), "r"(hi[3]), "r"(hi[4]),
          "r"(hi[5]), "r"(hi[6]), "r"(hi[7]));
  }
  return fe8_reduce_wide(r);
}

// r[0..N-1] += x[0..N-1] in one chain, its carry out set into r[N]
// (fe8_sq's rows of N < 7 products: the asm operands are fixed per N).
template <int N>
__device__ __forceinline__ void fe8_chain_carry(uint32_t* r,
                                                const uint32_t* x) {
  if constexpr (N == 1) {
    asm("add.cc.u32 %0, %0, %2;\n\t"
        "addc.u32 %1, 0, 0;"
        : "+r"(r[0]), "=r"(r[1])
        : "r"(x[0]));
  } else if constexpr (N == 2) {
    asm("add.cc.u32 %0, %0, %3;\n\t"
        "addc.cc.u32 %1, %1, %4;\n\t"
        "addc.u32 %2, 0, 0;"
        : "+r"(r[0]), "+r"(r[1]), "=r"(r[2])
        : "r"(x[0]), "r"(x[1]));
  } else if constexpr (N == 3) {
    asm("add.cc.u32 %0, %0, %4;\n\t"
        "addc.cc.u32 %1, %1, %5;\n\t"
        "addc.cc.u32 %2, %2, %6;\n\t"
        "addc.u32 %3, 0, 0;"
        : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "=r"(r[3])
        : "r"(x[0]), "r"(x[1]), "r"(x[2]));
  } else if constexpr (N == 4) {
    asm("add.cc.u32 %0, %0, %5;\n\t"
        "addc.cc.u32 %1, %1, %6;\n\t"
        "addc.cc.u32 %2, %2, %7;\n\t"
        "addc.cc.u32 %3, %3, %8;\n\t"
        "addc.u32 %4, 0, 0;"
        : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "=r"(r[4])
        : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]));
  } else if constexpr (N == 5) {
    asm("add.cc.u32 %0, %0, %6;\n\t"
        "addc.cc.u32 %1, %1, %7;\n\t"
        "addc.cc.u32 %2, %2, %8;\n\t"
        "addc.cc.u32 %3, %3, %9;\n\t"
        "addc.cc.u32 %4, %4, %10;\n\t"
        "addc.u32 %5, 0, 0;"
        : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]), "=r"(r[5])
        : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]));
  } else if constexpr (N == 6) {
    asm("add.cc.u32 %0, %0, %7;\n\t"
        "addc.cc.u32 %1, %1, %8;\n\t"
        "addc.cc.u32 %2, %2, %9;\n\t"
        "addc.cc.u32 %3, %3, %10;\n\t"
        "addc.cc.u32 %4, %4, %11;\n\t"
        "addc.cc.u32 %5, %5, %12;\n\t"
        "addc.u32 %6, 0, 0;"
        : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]), "+r"(r[5]), "=r"(r[6])
        : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]), "r"(x[5]));
  }
}

// r[0..N-1] += x[0..N-1] in one chain whose last word carries out 0.
template <int N>
__device__ __forceinline__ void fe8_chain(uint32_t* r,
                                          const uint32_t* x) {
  if constexpr (N == 1) {
    asm("add.u32 %0, %0, %1;"
        : "+r"(r[0])
        : "r"(x[0]));
  } else if constexpr (N == 2) {
    asm("add.cc.u32 %0, %0, %2;\n\t"
        "addc.u32 %1, %1, %3;"
        : "+r"(r[0]), "+r"(r[1])
        : "r"(x[0]), "r"(x[1]));
  } else if constexpr (N == 3) {
    asm("add.cc.u32 %0, %0, %3;\n\t"
        "addc.cc.u32 %1, %1, %4;\n\t"
        "addc.u32 %2, %2, %5;"
        : "+r"(r[0]), "+r"(r[1]), "+r"(r[2])
        : "r"(x[0]), "r"(x[1]), "r"(x[2]));
  } else if constexpr (N == 4) {
    asm("add.cc.u32 %0, %0, %4;\n\t"
        "addc.cc.u32 %1, %1, %5;\n\t"
        "addc.cc.u32 %2, %2, %6;\n\t"
        "addc.u32 %3, %3, %7;"
        : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3])
        : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]));
  } else if constexpr (N == 5) {
    asm("add.cc.u32 %0, %0, %5;\n\t"
        "addc.cc.u32 %1, %1, %6;\n\t"
        "addc.cc.u32 %2, %2, %7;\n\t"
        "addc.cc.u32 %3, %3, %8;\n\t"
        "addc.u32 %4, %4, %9;"
        : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4])
        : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]));
  } else if constexpr (N == 6) {
    asm("add.cc.u32 %0, %0, %6;\n\t"
        "addc.cc.u32 %1, %1, %7;\n\t"
        "addc.cc.u32 %2, %2, %8;\n\t"
        "addc.cc.u32 %3, %3, %9;\n\t"
        "addc.cc.u32 %4, %4, %10;\n\t"
        "addc.u32 %5, %5, %11;"
        : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]), "+r"(r[5])
        : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]), "r"(x[5]));
  }
}


// Row i (1..6) of fe8_sq: the N = 7 - i cross products a_i a_j, j > i, low
// halves into words 2i+1..i+7 with the carry into i+8, high halves into
// 2i+2..i+8.
template <int I>
__device__ __forceinline__ void fe8_sq_row(const fe8& a, uint32_t* r) {
  constexpr int N = 7 - I;
  uint32_t lo[N], hi[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const uint64_t p = (uint64_t)a.v[I] * a.v[I + 1 + k];
    lo[k] = (uint32_t)p;
    hi[k] = (uint32_t)(p >> 32);
  }
  fe8_chain_carry<N>(r + 2 * I + 1, lo);
  fe8_chain<N>(r + 2 * I + 2, hi);
}

// a^2 in 36 products (mul.wide.u32): the 28 cross products a_i a_j, i < j,
// by rows as fe8_mul takes them (row 0 in one chain, rows 1..6 by
// fe8_sq_row), their sum C doubled by a chain (C + C; C < 2^480, so the
// doubling carries into word 15), the 8 squares a_i^2 added at words 2i
// and 2i+1 by a chain (a^2 < 2^512: its last word carries out 0), then
// fe8_reduce_wide.  After row i the cross partial sum is below
// a[0..i] a < 2^(32(i + 9)), so row i's high chain carries out 0, as
// fe8_mul's does.
__device__ FE8_MUL_INLINE fe8 fe8_sq(const fe8& a) {
  uint32_t r[16], lo[8], hi[8];
#pragma unroll
  for (int j = 1; j < 8; ++j) {
    const uint64_t p = (uint64_t)a.v[0] * a.v[j];
    lo[j] = (uint32_t)p;
    hi[j] = (uint32_t)(p >> 32);
  }
  r[1] = lo[1];
  asm("add.cc.u32 %0, %7, %8;\n\t"
      "addc.cc.u32 %1, %9, %10;\n\t"
      "addc.cc.u32 %2, %11, %12;\n\t"
      "addc.cc.u32 %3, %13, %14;\n\t"
      "addc.cc.u32 %4, %15, %16;\n\t"
      "addc.cc.u32 %5, %17, %18;\n\t"
      "addc.u32 %6, %19, 0;"
      : "=r"(r[2]), "=r"(r[3]), "=r"(r[4]), "=r"(r[5]), "=r"(r[6]),
        "=r"(r[7]), "=r"(r[8])
      : "r"(lo[2]), "r"(hi[1]), "r"(lo[3]), "r"(hi[2]), "r"(lo[4]),
        "r"(hi[3]), "r"(lo[5]), "r"(hi[4]), "r"(lo[6]), "r"(hi[5]),
        "r"(lo[7]), "r"(hi[6]), "r"(hi[7]));
  fe8_sq_row<1>(a, r);
  fe8_sq_row<2>(a, r);
  fe8_sq_row<3>(a, r);
  fe8_sq_row<4>(a, r);
  fe8_sq_row<5>(a, r);
  fe8_sq_row<6>(a, r);
  asm("add.cc.u32 %0, %0, %0;\n\t"
      "addc.cc.u32 %1, %1, %1;\n\t"
      "addc.cc.u32 %2, %2, %2;\n\t"
      "addc.cc.u32 %3, %3, %3;\n\t"
      "addc.cc.u32 %4, %4, %4;\n\t"
      "addc.cc.u32 %5, %5, %5;\n\t"
      "addc.cc.u32 %6, %6, %6;\n\t"
      "addc.cc.u32 %7, %7, %7;\n\t"
      "addc.cc.u32 %8, %8, %8;\n\t"
      "addc.cc.u32 %9, %9, %9;\n\t"
      "addc.cc.u32 %10, %10, %10;\n\t"
      "addc.cc.u32 %11, %11, %11;\n\t"
      "addc.cc.u32 %12, %12, %12;\n\t"
      "addc.cc.u32 %13, %13, %13;\n\t"
      "addc.u32 %14, 0, 0;"
      : "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]), "+r"(r[5]),
        "+r"(r[6]), "+r"(r[7]), "+r"(r[8]), "+r"(r[9]), "+r"(r[10]),
        "+r"(r[11]), "+r"(r[12]), "+r"(r[13]), "+r"(r[14]), "=r"(r[15]));
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint64_t p = (uint64_t)a.v[j] * a.v[j];
    lo[j] = (uint32_t)p;
    hi[j] = (uint32_t)(p >> 32);
  }
  r[0] = lo[0];
  asm("add.cc.u32 %0, %0, %15;\n\t"
      "addc.cc.u32 %1, %1, %16;\n\t"
      "addc.cc.u32 %2, %2, %17;\n\t"
      "addc.cc.u32 %3, %3, %18;\n\t"
      "addc.cc.u32 %4, %4, %19;\n\t"
      "addc.cc.u32 %5, %5, %20;\n\t"
      "addc.cc.u32 %6, %6, %21;\n\t"
      "addc.cc.u32 %7, %7, %22;\n\t"
      "addc.cc.u32 %8, %8, %23;\n\t"
      "addc.cc.u32 %9, %9, %24;\n\t"
      "addc.cc.u32 %10, %10, %25;\n\t"
      "addc.cc.u32 %11, %11, %26;\n\t"
      "addc.cc.u32 %12, %12, %27;\n\t"
      "addc.cc.u32 %13, %13, %28;\n\t"
      "addc.u32 %14, %14, %29;"
      : "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]), "+r"(r[5]),
        "+r"(r[6]), "+r"(r[7]), "+r"(r[8]), "+r"(r[9]), "+r"(r[10]),
        "+r"(r[11]), "+r"(r[12]), "+r"(r[13]), "+r"(r[14]), "+r"(r[15])
      : "r"(hi[0]), "r"(lo[1]), "r"(hi[1]), "r"(lo[2]), "r"(hi[2]),
        "r"(lo[3]), "r"(hi[3]), "r"(lo[4]), "r"(hi[4]), "r"(lo[5]),
        "r"(hi[5]), "r"(lo[6]), "r"(hi[6]), "r"(lo[7]), "r"(hi[7]));
  return fe8_reduce_wide(r);
}

// Balanced 13-bit limbs (|limb| <= 8191) of a signed value V -> the weak
// form of V mod p.  `limb(i)` returns limb i as an int32_t: a strided
// global load (fe8_from_limbs20 below) or a register (K2t's table copy).
template <class F>
__device__ __forceinline__ fe8 fe8_from_limbs20_f(F limb) {
  fe8 r;
  int64_t acc = 0;
  int k = 0;
#pragma unroll
  for (int i = 0; i < 20; ++i) {
    acc += (int64_t)limb(i) * ((int64_t)1 << (13 * i - 32 * k));
    // word k is complete once no later limb starts below bit 32(k + 1)
    if (k < 7 && 13 * (i + 1) >= 32 * (k + 1)) {
      r.v[k] = (uint32_t)acc;
      acc >>= 32;
      ++k;
    }
  }
  r.v[7] = (uint32_t)acc & 0x7fffffffu;
  const int32_t s = 19 * (int32_t)(acc >> 31);
  const uint32_t sx = (uint32_t)(s >> 31);
  uint32_t cc;
  asm("add.cc.u32 %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, %10;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %10;\n\t"
      "addc.cc.u32 %4, %4, %10;\n\t"
      "addc.cc.u32 %5, %5, %10;\n\t"
      "addc.cc.u32 %6, %6, %10;\n\t"
      "addc.cc.u32 %7, %7, %10;\n\t"
      "addc.u32 %8, %10, 0;"
      : "+r"(r.v[0]), "+r"(r.v[1]), "+r"(r.v[2]), "+r"(r.v[3]),
        "+r"(r.v[4]), "+r"(r.v[5]), "+r"(r.v[6]), "+r"(r.v[7]), "=r"(cc)
      : "r"((uint32_t)s), "r"(sx));
  asm("sub.cc.u32 %0, %0, %8;\n\t"
      "subc.cc.u32 %1, %1, 0;\n\t"
      "subc.cc.u32 %2, %2, 0;\n\t"
      "subc.cc.u32 %3, %3, 0;\n\t"
      "subc.cc.u32 %4, %4, 0;\n\t"
      "subc.cc.u32 %5, %5, 0;\n\t"
      "subc.cc.u32 %6, %6, 0;\n\t"
      "subc.u32 %7, %7, 0;"
      : "+r"(r.v[0]), "+r"(r.v[1]), "+r"(r.v[2]), "+r"(r.v[3]),
        "+r"(r.v[4]), "+r"(r.v[5]), "+r"(r.v[6]), "+r"(r.v[7])
      : "r"(cc & 38u));
  return r;
}

template <typename L>
__device__ __forceinline__ fe8 fe8_from_limbs20(const L* limbs,
                                                size_t stride) {
  return fe8_from_limbs20_f(
      [&](int i) { return (int32_t)limbs[(size_t)i * stride]; });
}

// The canonical residue of a in [0, p) as 20 balanced 13-bit limbs,
// |limb| <= 4096: the limbs ops/limbs' balanced digit split gives.
__device__ __forceinline__ void fe8_to_limbs20_canonical(const fe8& a,
                                                         int32_t* out) {
  fe8 x = a;
  const uint32_t q19 = (x.v[7] >> 31) * 19u;
  x.v[7] &= 0x7fffffffu;
  asm("add.cc.u32 %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, 0;\n\t"
      "addc.cc.u32 %2, %2, 0;\n\t"
      "addc.cc.u32 %3, %3, 0;\n\t"
      "addc.cc.u32 %4, %4, 0;\n\t"
      "addc.cc.u32 %5, %5, 0;\n\t"
      "addc.cc.u32 %6, %6, 0;\n\t"
      "addc.u32 %7, %7, 0;"
      : "+r"(x.v[0]), "+r"(x.v[1]), "+r"(x.v[2]), "+r"(x.v[3]),
        "+r"(x.v[4]), "+r"(x.v[5]), "+r"(x.v[6]), "+r"(x.v[7])
      : "r"(q19));
  fe8 y;
  asm("add.cc.u32 %0, %8, 19;\n\t"
      "addc.cc.u32 %1, %9, 0;\n\t"
      "addc.cc.u32 %2, %10, 0;\n\t"
      "addc.cc.u32 %3, %11, 0;\n\t"
      "addc.cc.u32 %4, %12, 0;\n\t"
      "addc.cc.u32 %5, %13, 0;\n\t"
      "addc.cc.u32 %6, %14, 0;\n\t"
      "addc.u32 %7, %15, 0;"
      : "=r"(y.v[0]), "=r"(y.v[1]), "=r"(y.v[2]), "=r"(y.v[3]),
        "=r"(y.v[4]), "=r"(y.v[5]), "=r"(y.v[6]), "=r"(y.v[7])
      : "r"(x.v[0]), "r"(x.v[1]), "r"(x.v[2]), "r"(x.v[3]), "r"(x.v[4]),
        "r"(x.v[5]), "r"(x.v[6]), "r"(x.v[7]));
  const bool ge = (y.v[7] >> 31) != 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) x.v[i] = ge ? y.v[i] : x.v[i];
  x.v[7] &= 0x7fffffffu;
  int32_t u[20];
#pragma unroll
  for (int i = 0; i < 20; ++i) {
    const int bit = 13 * i, k = bit >> 5, s = bit & 31;
    const uint32_t hi = k + 1 < 8 ? x.v[k + 1 < 8 ? k + 1 : 7] : 0u;
    u[i] = (int32_t)(__funnelshift_r(x.v[k], hi, s) & 8191u);
  }
#pragma unroll
  for (int i = 0; i < 19; ++i) {
    const int32_t c = (u[i] + 4096) >> 13;
    u[i] -= c * 8192;
    u[i + 1] += c;
  }
#pragma unroll
  for (int i = 0; i < 20; ++i) out[i] = u[i];
}

__device__ __forceinline__ ge8 ge8_identity() {
  ge8 r;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    r.X.v[i] = 0u;
    r.Y.v[i] = 0u;
    r.Z.v[i] = 0u;
    r.T.v[i] = 0u;
  }
  r.Y.v[0] = 1u;
  r.Z.v[0] = 1u;
  return r;
}

// Complete unified addition (add-2008-hwcd-3, a = -1, k = 2d): the field-op
// sequence of fe25519.cuh ge_add with the x2 as an add, so every
// coordinate is the same residue mod p as the 20-limb arithmetic's.  With
// `neg`, q is taken as -q = (-X2, Y2, Z2, -T2) without negating anything:
// Y2 - X2 and Y2 + X2 trade places, and so do F and G (C changes sign) —
// the same residues as the negated operand gives.  The order of the
// independent products keeps at most ~64 words live (p's and q's
// coordinates die as their sums are taken).
__device__ __forceinline__ ge8 ge8_add(const ge8& p, const ge8& q,
                                       bool neg = false) {
  const fe8 s1 = fe8_sub(p.Y, p.X);
  const fe8 a1 = fe8_add(p.Y, p.X);
  fe8 s2 = fe8_sub(q.Y, q.X);
  fe8 a2 = fe8_add(q.Y, q.X);
  if (neg) {
    const fe8 t = s2;
    s2 = a2;
    a2 = t;
  }
  fe8 d2;
#pragma unroll
  for (int i = 0; i < 8; ++i) d2.v[i] = FE8_D2[i];
  const fe8 C = fe8_mul(fe8_mul(p.T, d2), q.T);
  const fe8 Dz = fe8_mul(p.Z, q.Z);
  const fe8 A = fe8_mul(s1, s2);
  const fe8 B = fe8_mul(a1, a2);
  const fe8 D = fe8_add(Dz, Dz);
  const fe8 E = fe8_sub(B, A);
  fe8 F = fe8_sub(D, C);
  fe8 G = fe8_add(D, C);
  const fe8 H = fe8_add(B, A);
  if (neg) {
    const fe8 t = F;
    F = G;
    G = t;
  }
  ge8 r;
  r.X = fe8_mul(E, F);
  r.Y = fe8_mul(G, H);
  r.Z = fe8_mul(F, G);
  r.T = fe8_mul(E, H);
  return r;
}

// Dedicated doubling (dbl-2008-hwcd, a = -1): 4 fe8_sq, 4 fe8_mul, 3
// fe8_add, 3 fe8_sub and one fe8_neg; T is not read.  The formula of the
// host's Point.double (ops/edwards.py) and of torch_edwards.point_double,
// so every coordinate is their residue; ops/fe_u32.py ge8_dbl models it.
// Complete on Edwards25519 (a = -1 is a square, d is not): the identity
// and the torsion points double exactly.
__device__ __forceinline__ ge8 ge8_dbl(const ge8& p) {
  const fe8 A = fe8_sq(p.X);
  const fe8 B = fe8_sq(p.Y);
  const fe8 zz = fe8_sq(p.Z);
  const fe8 S = fe8_sq(fe8_add(p.X, p.Y));
  const fe8 C = fe8_add(zz, zz);
  const fe8 AB = fe8_add(A, B);
  const fe8 E = fe8_sub(S, AB);
  const fe8 G = fe8_sub(B, A);
  const fe8 F = fe8_sub(G, C);
  const fe8 H = fe8_neg(AB);
  ge8 r;
  r.X = fe8_mul(E, F);
  r.Y = fe8_mul(G, H);
  r.Z = fe8_mul(F, G);
  r.T = fe8_mul(E, H);
  return r;
}
