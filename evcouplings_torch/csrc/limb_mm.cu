// K5: the bf16-limb product of the precision names "high" and "default",
// by hand for Hopper.
//
// Replaces the limb passes of ops/plm._mm (before this kernel: one
// torch.mm(..., out_dtype=float32) pass per limb into a fresh float32
// partial, then partial adds), which implement the JAX package's
// definition of those names: evcouplings_tpu/ops/plm.py, _PrecTriple /
// _precision (lines 140-185), where XLA's dot splits the float32 operand
// of every one-hot product into 2 ("high") or 1 ("default") bf16 limbs
// inside one fused product. It replaces no Pallas kernel.
//
// Function: C (+)= sum_l A_l . B, accumulated in float32, where A_l are
// the n in {1, 2} bf16 limbs of a float32 operand A (hi = bf16(a), lo =
// bf16(a - hi), each rounded to nearest even, as ops/plm._split_limbs
// defines them) and B is exactly bf16 (a one-hot). Three forms, one body:
//   kGrad     dJh += split(r^T) . onehot: A[m][k] = r[k][m] (float32, M
//             contiguous), B[k][n] = onehot[k][n], C[m][n], accumulate;
//   kStored   the same with A given as its stored bf16 limbs (the residual
//             store of the two-phase layouts);
//   kLogitsKM logits = onehot . split(J): computed transposed, C^T[m][n] =
//             logits[n][m], A[m][k] = J[k][m] (float32, M contiguous),
//             B[k][n] = onehot[n][k];
//   kLogitsMK the same with A[m][k] = J[m][k] (K contiguous: onehot .
//             split(J^T), the loss builder and the per-site fit).
//
// What bounds it. The gradient form at the main path's shapes (a block of
// B = 512 rows, Lq = 3360, Lq_aug = 3456, "high") does 2 Lq Lq_aug B x 2
// limbs = 23.8 GFLOP of bf16 tensor-core work (24 us at 989 TFLOP/s) and
// must move dJh in and out once (92.9 MB) plus r (6.9 MB) and the one-hot
// (3.5 MB): 103 MB, 31 us at 3.35 TB/s. So it is bound by bytes, and by
// the accumulator's round trip above all; the route it replaces wrote and
// read every limb pass's (Lq, Lq_aug) float32 partial through device
// memory three more times.
//
// Design. Every limb pass of one output element goes into ONE float32
// register accumulator, and the epilogue adds it into C: C is read once
// and written once, no partial product reaches device memory, and the
// float32 operand is split in registers as it is loaded.
//   - Tiles: 64 kWG rows (kWG warpgroups of 128 threads, one per 64 rows)
//     by 128 columns per block, depth kKC = 32 per stage, kStages = 4
//     stages (cp.async: the next three stages are in flight while one is
//     multiplied). kWG = 2 where the grid has at least two waves of such
//     blocks, else 1 (the logits form: N is the 512 rows of a block). The
//     result does not depend on the tile: each element's sum runs over the
//     same k-steps in the same order.
//   - A (the float32 operand) is copied to shared memory as it lies in
//     device memory (rows padded against bank conflicts) and split, per
//     16-deep k-step, into the bf16 register fragments that wgmma takes as
//     its A operand (m64n128k16, A from registers): the limbs never exist
//     outside registers. The stored form reads its limbs as they are.
//   - B (the one-hot) is copied to shared memory in wgmma's no-swizzle
//     layout of 8 x 16-byte core matrices: MN-major for the gradient forms
//     (the one-hot's rows are the contraction, transposed B), K-major for
//     the logits forms.
//   - Order: per k-step the hi limb's product, then the lo limb's, into
//     the same accumulator; k-steps in index order. No split-K and no
//     atomics, so a result is bitwise the same on every run.
//   - Ragged edges: a 16-byte chunk that lies wholly inside the operand
//     and is 16-byte aligned is copied by cp.async; any other (the edge
//     of M, N or K, or an operand whose rows are not 16-byte aligned, as
//     the unpadded one-hot of the per-site fit at most L) element by
//     element, zero past the edge.
//   - Copies: each thread's chunks of a stage lie at fixed offsets from
//     one row to the next, set once per block (Plan); the epilogue issues
//     its reads of C a group of column blocks ahead of their writes.
// The tensor cores accumulate in float32 but need not round each add as
// IEEE float32 does; chip_smoke.py (phase 3c) holds the kernel against
// float64 as well as against its plain version (kernels/limb_mm.py).
//
// Where it stands (chip_smoke.py phase 3c, NVIDIA H100 80GB HBM3, 700 W):
// the gradient form above took 0.130 ms at "high" against 0.183 ms for
// the route it replaced and 0.031 ms of bound; the logits form 0.149 ms
// (bound 0.024), at one limb as at two; end to end it is slower than that
// route at both "high" and "default". Its time follows the bytes its
// tiles pull from L2 through per-thread cp.async, not its operations: a
// design with TMA copies from a producer warp, and for the logits forms
// one-hot tiles multicast across a cluster, is the next step.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum Form { kGrad = 0, kStored = 1, kLogitsKM = 2, kLogitsMK = 3 };

constexpr int kBN = 128;                  // output columns per block
constexpr int kKC = 32;                   // contraction depth per stage
constexpr int kSteps = kKC / 16;          // wgmma k-steps per stage
constexpr int kLBO = 128;                 // B: core matrices along K
constexpr int kSBO = (kKC / 8) * 128;     // B: core matrices along N
constexpr int kBBytes = kKC * kBN * 2;    // B stage bytes
constexpr int kStages = 4;                // stages in shared memory

struct Args {
  const void* a[2];     // float32 operand, or its bf16 limbs (kStored)
  const uint16_t* b;    // bf16 one-hot (bits)
  float* c;
  int M, N, K;
  long long lda, ldb, ldc;
  int a_vec, b_vec, accumulate;
};

template <int kForm, int kNL, int kWG>
struct Tile {
  static constexpr int kBM = 64 * kWG;
  static constexpr int kThreads = 128 * kWG;
  static constexpr bool kFloat = kForm != kStored;
  // A in shared memory: [k][m] rows of kLdKM elements (float32: 4 mod 32
  // words, bf16: 8 elements of padding, no conflicts on the fragment
  // loads), or [m][k] rows of kLdMK floats (kLogitsMK, 8 mod 32 words)
  static constexpr int kLdKM = kBM + (kFloat ? 4 : 8);
  static constexpr int kLdMK = kKC + 8;
  static constexpr int kABytes =
      kForm == kLogitsMK ? kBM * kLdMK * 4
                         : (kFloat ? kKC * kLdKM * 4 : kNL * kKC * kLdKM * 2);
  static constexpr int kStageBytes = (kBBytes + kABytes + 127) / 128 * 128;
  static constexpr int kSmem = kStages * kStageBytes;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory matrix descriptor: start address, leading byte
// offset (K direction), stride byte offset (N direction), no swizzle.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kLBO >> 4) << 16) |
         (static_cast<uint64_t>(kSBO >> 4) << 32);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// d[64] += A (64 x 16, bf16 registers) . B (16 x 128, bf16 in shared
// memory; kTransB: MN-major).
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(kTransB));
}

// Keep the compiler from moving register accesses across wgmma, which
// reads its A fragments and writes its accumulators asynchronously.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int kNL>
__device__ __forceinline__ void fence_frag(uint32_t (&f)[kSteps][kNL][4]) {
#pragma unroll
  for (int s = 0; s < kSteps; ++s)
#pragma unroll
    for (int l = 0; l < kNL; ++l)
#pragma unroll
      for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(f[s][l][i])::"memory");
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo_col,
                                         __nv_bfloat16 hi_col) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo_col)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi_col)) << 16);
}

// The limbs of two neighbouring elements (columns k, k + 1 of a fragment
// row): out[0] their hi limbs, out[1] (kNL == 2) their lo limbs.
template <int kNL>
__device__ __forceinline__ void split_pair(float x0, float x1,
                                           uint32_t* out, int stride) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0);
  const __nv_bfloat16 h1 = __float2bfloat16_rn(x1);
  out[0] = pack(h0, h1);
  if (kNL == 2)
    out[stride] = pack(__float2bfloat16_rn(x0 - __bfloat162float(h0)),
                       __float2bfloat16_rn(x1 - __bfloat162float(h1)));
}

// A thread's share of one operand's stage: kSlots 16-byte chunks, slot j
// in row row0 + j kRowStep of the operand's strided dimension (K for the
// KM / KN layouts, M or N for MK / NK), all at the same offset col0 along
// its contiguous one. Everything but the stage's k0 is set once per block.
struct Slots {
  const unsigned char* src;  // slot 0's chunk at k0 = 0
  long long step;            // bytes from one slot's row to the next's
  int row0;                  // slot 0's row (KM: its k; MK: its m or n)
  int col0;                  // the chunks' offset along the contiguous dim
  uint32_t dst;              // slot 0's byte offset in a stage
};

// The chunks of one operand for the stage at k0: by cp.async where a
// chunk lies wholly inside the operand and `vec` holds, else element by
// element (zero past the edge). kKMajor: rows are k (KM / KN: the chunk
// runs along M or N, `extent` of it); else rows are m or n (`rows` of
// them) and the chunk runs along k.
template <typename T, int kSlots, int kRowStep, int kDstStep, bool kRowsAreK>
__device__ __forceinline__ void load_slots(const Slots& sl,
                                           unsigned char* stage, int k0,
                                           int K, int rows, int extent,
                                           long long ld, bool vec) {
  constexpr int kE = 16 / static_cast<int>(sizeof(T));
  const unsigned char* src =
      sl.src + (kRowsAreK ? static_cast<long long>(k0) * ld * sizeof(T)
                          : static_cast<long long>(k0) * sizeof(T));
  // along the contiguous dimension: the elements left from col0
  const int left = kRowsAreK ? extent - sl.col0 : K - k0 - sl.col0;
  const int valid_cols = left <= 0 ? 0 : (left < kE ? left : kE);
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int row = sl.row0 + j * kRowStep;
    const bool row_ok = kRowsAreK ? k0 + row < K : row < rows;
    const int valid = row_ok ? valid_cols : 0;
    const T* from = reinterpret_cast<const T*>(src + j * sl.step);
    unsigned char* to = stage + sl.dst + j * kDstStep;
    if (vec && valid == kE) {
      cp_async16(to, from);
    } else {
      T* d = reinterpret_cast<T*>(to);
#pragma unroll
      for (int e = 0; e < kE; ++e) d[e] = e < valid ? from[e] : T(0);
    }
  }
}

template <int kForm, int kNL, int kWG>
struct Plan {
  using T = Tile<kForm, kNL, kWG>;
  static constexpr int kBM = T::kBM;
  static constexpr int kThreads = T::kThreads;
  static constexpr bool kGradB = kForm == kGrad || kForm == kStored;
  // B: kKC x kBN bf16 in 8 x 8 core matrices, core (k8, n8) at n8 kSBO +
  // k8 kLBO; 8 neighbouring threads fill one core matrix (128 bytes)
  static constexpr int kBSlots = kKC * kBN / 8 / kThreads;
  // KN (gradient forms): chunk c is k = 8 (c >> 7) + (c & 7), n8 = (c >>
  // 3) & 15; NK (logits forms): n = 8 (c / (8 kK8)) + (c & 7), k8 = (c >>
  // 3) % kK8, with kK8 = kKC / 8 core matrices along K
  static constexpr int kK8 = kKC / 8;
  static constexpr int kBRowStep = kGradB ? 8 * kThreads / 128
                                          : kThreads / kK8;
  static constexpr int kBDstStep = kGradB ? (kThreads / 128) * kLBO
                                          : (kThreads / (8 * kK8)) * kSBO;
  // A: KM float32 (kBM / 4 chunks per k row), MK float32 (kKC / 4 per m
  // row), stored bf16 (kBM / 8 per k row, per limb)
  static constexpr int kAPerRow =
      kForm == kLogitsMK ? kKC / 4 : (T::kFloat ? kBM / 4 : kBM / 8);
  static constexpr int kASlots = kKC * kBM / (T::kFloat ? 4 : 8) / kThreads;
  static constexpr int kARowStep = kThreads / kAPerRow;
  static constexpr int kADstStep =
      kARowStep * (kForm == kLogitsMK ? T::kLdMK * 4
                                      : T::kLdKM * (T::kFloat ? 4 : 2));
  static constexpr int kALimbBytes = kKC * T::kLdKM * 2;

  Slots a, a1, b;

  __device__ __forceinline__ Plan(const Args& p, int m0, int n0, int tid) {
    if (kGradB) {
      const int k = 8 * (tid >> 7) + (tid & 7);
      const int n8 = (tid >> 3) & 15;
      b = {reinterpret_cast<const unsigned char*>(p.b + k * p.ldb + n0 +
                                                  8 * n8),
           static_cast<long long>(kBRowStep) * p.ldb * 2, k, n0 + 8 * n8,
           static_cast<uint32_t>(n8 * kSBO + (k >> 3) * kLBO +
                                 (k & 7) * 16)};
    } else {
      const int n = 8 * (tid / (8 * kK8)) + (tid & 7);
      const int k8 = (tid >> 3) % kK8;
      b = {reinterpret_cast<const unsigned char*>(
               p.b + static_cast<long long>(n0 + n) * p.ldb + 8 * k8),
           static_cast<long long>(kBRowStep) * p.ldb * 2, n0 + n, 8 * k8,
           static_cast<uint32_t>((n >> 3) * kSBO + k8 * kLBO +
                                 (n & 7) * 16)};
    }
    const int row = tid / kAPerRow;
    const int col = tid % kAPerRow;
    if (kForm == kLogitsMK) {
      const float* A = static_cast<const float*>(p.a[0]);
      a = {reinterpret_cast<const unsigned char*>(
               A + static_cast<long long>(m0 + row) * p.lda + 4 * col),
           static_cast<long long>(kARowStep) * p.lda * 4, m0 + row, 4 * col,
           static_cast<uint32_t>(kBBytes + (row * T::kLdMK + 4 * col) * 4)};
    } else if (T::kFloat) {
      const float* A = static_cast<const float*>(p.a[0]);
      a = {reinterpret_cast<const unsigned char*>(A + row * p.lda + m0 +
                                                  4 * col),
           static_cast<long long>(kARowStep) * p.lda * 4, row, m0 + 4 * col,
           static_cast<uint32_t>(kBBytes + (row * T::kLdKM + 4 * col) * 4)};
    } else {
      const int e = 8 * col;
      a = {reinterpret_cast<const unsigned char*>(
               static_cast<const uint16_t*>(p.a[0]) + row * p.lda + m0 + e),
           static_cast<long long>(kARowStep) * p.lda * 2, row, m0 + e,
           static_cast<uint32_t>(kBBytes + (row * T::kLdKM + e) * 2)};
      a1 = a;
      if (kNL == 2) {
        a1.src = reinterpret_cast<const unsigned char*>(
            static_cast<const uint16_t*>(p.a[1]) + row * p.lda + m0 + e);
        a1.dst += kALimbBytes;
      }
    }
  }

  // One stage: the A and B chunks of contraction rows [k0, k0 + kKC).
  __device__ __forceinline__ void load(const Args& p, unsigned char* stage,
                                       int k0) const {
    const bool bvec = p.b_vec != 0;
    const bool avec = p.a_vec != 0;
    if (kGradB)
      load_slots<uint16_t, kBSlots, kBRowStep, kBDstStep, true>(
          b, stage, k0, p.K, p.N, p.N, p.ldb, bvec);
    else
      load_slots<uint16_t, kBSlots, kBRowStep, kBDstStep, false>(
          b, stage, k0, p.K, p.N, p.N, p.ldb, bvec);
    if (kForm == kLogitsMK) {
      load_slots<float, kASlots, kARowStep, kADstStep, false>(
          a, stage, k0, p.K, p.M, p.M, p.lda, avec);
    } else if (T::kFloat) {
      load_slots<float, kASlots, kARowStep, kADstStep, true>(
          a, stage, k0, p.K, p.M, p.M, p.lda, avec);
    } else {
      load_slots<uint16_t, kASlots, kARowStep, kADstStep, true>(
          a, stage, k0, p.K, p.M, p.M, p.lda, avec);
      if (kNL == 2)
        load_slots<uint16_t, kASlots, kARowStep, kADstStep, true>(
            a1, stage, k0, p.K, p.M, p.M, p.lda, avec);
    }
  }
};

// The A fragments of the kSteps k-steps of a stage for fragment row r (and
// r + 8) and column pair 2t: f[step][limb][reg], the wgmma m64k16 register
// layout (reg 0: row r, columns 2t, 2t + 1; reg 1: row r + 8; regs 2, 3:
// the same rows, columns + 8).
template <int kForm, int kNL, int kWG>
__device__ __forceinline__ void build_frags(const unsigned char* stage,
                                            int r, int t,
                                            uint32_t (&f)[kSteps][kNL][4]) {
  using T = Tile<kForm, kNL, kWG>;
  const unsigned char* sa = stage + kBBytes;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r + 8 * (i & 1);
      const int col = 16 * s + 2 * t + 8 * (i >> 1);
      if (kForm == kLogitsMK) {
        const float2 x = *reinterpret_cast<const float2*>(
            reinterpret_cast<const float*>(sa) + row * T::kLdMK + col);
        split_pair<kNL>(x.x, x.y, &f[s][0][i], 4);
      } else if (T::kFloat) {
        const float* a = reinterpret_cast<const float*>(sa);
        split_pair<kNL>(a[col * T::kLdKM + row], a[(col + 1) * T::kLdKM + row],
                        &f[s][0][i], 4);
      } else {
#pragma unroll
        for (int l = 0; l < kNL; ++l) {
          const uint16_t* a =
              reinterpret_cast<const uint16_t*>(sa) + l * kKC * T::kLdKM;
          f[s][l][i] = static_cast<uint32_t>(a[col * T::kLdKM + row]) |
                       (static_cast<uint32_t>(a[(col + 1) * T::kLdKM + row])
                        << 16);
        }
      }
    }
  }
}

template <int kForm, int kNL, int kWG>
__global__ void __launch_bounds__(128 * kWG)
limb_mm_kernel(__grid_constant__ const Args p) {
  using T = Tile<kForm, kNL, kWG>;
  constexpr int kTransB = (kForm == kGrad || kForm == kStored) ? 1 : 0;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * T::kBM;
  const int n0 = blockIdx.y * kBN;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  // this thread's first fragment row: warpgroup tid / 128, warp (tid /
  // 32) % 4 of it, row lane / 4 of that warp's 16
  const int r = 64 * (tid / 128) + 16 * ((tid / 32) % 4) + g;

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;

  const int chunks = (p.K + kKC - 1) / kKC;
  const Plan<kForm, kNL, kWG> plan(p, m0, n0, tid);
  // one commit group per chunk: kStages - 1 chunks in flight
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) plan.load(p, smem + s * T::kStageBytes, s * kKC);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int kt = 0; kt < chunks; ++kt) {
    // chunk kt's copies have landed (the kStages - 2 after it may not)
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    // refill the stage of chunk kt - 1: every warpgroup waited for the
    // products that read it before the barrier
    const int next = kt + kStages - 1;
    if (next < chunks)
      plan.load(p, smem + (next % kStages) * T::kStageBytes, next * kKC);
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    const unsigned char* stage = smem + (kt % kStages) * T::kStageBytes;
    uint32_t f[kSteps][kNL][4];
    build_frags<kForm, kNL, kWG>(stage, r, t, f);
    const uint32_t b_addr = smem_u32(stage);
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
#pragma unroll
      for (int l = 0; l < kNL; ++l)
        wgmma_m64n128k16<kTransB>(d, f[s][l],
                                  make_desc(b_addr + 2 * s * kLBO));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(d);
    fence_frag<kNL>(f);
  }

  // epilogue: d[4 j + 2 h + e] is row r + 8 h, column 8 j + 2 t + e. The
  // gradient forms' column pairs are neighbours in C: where C's rows are
  // 8-byte aligned, 8-byte accesses, the reads of kGroup column groups
  // issued before their writes (C's old values in flight together)
  constexpr bool kLogits = kForm == kLogitsKM || kForm == kLogitsMK;
  constexpr int kGroup = 4;
  const bool pairs = !kLogits && p.ldc % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(p.c) % 8 == 0;
#pragma unroll
  for (int j0 = 0; j0 < 16; j0 += kGroup) {
    float2 old[kGroup][2];
    bool vec[kGroup][2];
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long gm = m0 + r + 8 * h;
        const long long gn = n0 + 8 * (j0 + j) + 2 * t;
        vec[j][h] = pairs && gm < p.M && gn + 1 < p.N;
        old[j][h] = make_float2(0.0f, 0.0f);
        if (vec[j][h] && p.accumulate)
          old[j][h] = *reinterpret_cast<const float2*>(p.c + gm * p.ldc + gn);
      }
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long gm = m0 + r + 8 * h;
        const long long gn0 = n0 + 8 * (j0 + j) + 2 * t;
        const float* v = d + 4 * (j0 + j) + 2 * h;
        if (vec[j][h]) {
          *reinterpret_cast<float2*>(p.c + gm * p.ldc + gn0) =
              make_float2(old[j][h].x + v[0], old[j][h].y + v[1]);
          continue;
        }
        if (gm >= p.M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const long long gn = gn0 + e;
          if (gn < p.N) {
            float* out =
                kLogits ? p.c + gn * p.ldc + gm : p.c + gm * p.ldc + gn;
            *out = p.accumulate ? *out + v[e] : v[e];
          }
        }
      }
  }
}

constexpr int kMaxDevices = 64;

// The multiprocessors of the current device, read once per device.
int device_sms(int device) {
  static int sms[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return 132;
  if (!sms[device] &&
      cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    sms[device] = 132;
  return sms[device];
}

template <int kForm, int kNL, int kWG>
cudaError_t launch(const Args& p, int device, cudaStream_t stream) {
  using T = Tile<kForm, kNL, kWG>;
  // the shared-memory opt-in, once per instantiation and device
  static bool ready[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices || !ready[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        limb_mm_kernel<kForm, kNL, kWG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < kMaxDevices) ready[device] = true;
  }
  const dim3 grid((p.M + T::kBM - 1) / T::kBM, (p.N + kBN - 1) / kBN);
  limb_mm_kernel<kForm, kNL, kWG><<<grid, T::kThreads, T::kSmem, stream>>>(p);
  return cudaGetLastError();
}

// The warpgroups per block (kWG) of an M x N output on `device`: 2 where
// the grid of 128-row blocks has at least two waves, else 1.
int warpgroups(int M, int N, int device) {
  const long long wide = static_cast<long long>((M + 127) / 128) *
                         ((N + kBN - 1) / kBN);
  return wide >= 2LL * device_sms(device) ? 2 : 1;
}

template <int kForm, int kNL>
cudaError_t launch_tiles(const Args& p, cudaStream_t stream) {
  int device = -1;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return warpgroups(p.M, p.N, device) == 2
             ? launch<kForm, kNL, 2>(p, device, stream)
             : launch<kForm, kNL, 1>(p, device, stream);
}

template <int kForm>
cudaError_t launch_limbs(const Args& p, int limbs, cudaStream_t stream) {
  return limbs == 2 ? launch_tiles<kForm, 2>(p, stream)
                    : launch_tiles<kForm, 1>(p, stream);
}

}  // namespace

extern "C" {

// K5 launch, on `stream`:
//   form 0 (kGrad):     c[m ldc + n] (+)= sum_l limb_l(a[k lda + m]) b[k ldb + n]
//   form 1 (kStored):   the same with a0, a1 the stored bf16 limbs
//   form 2 (kLogitsKM): c[n ldc + m] (+)= sum_l limb_l(a[k lda + m]) b[n ldb + k]
//   form 3 (kLogitsMK): c[n ldc + m] (+)= sum_l limb_l(a[m lda + k]) b[n ldb + k]
// for m < M, n < N, k < K; a float32 (forms 0, 2, 3), b bf16, c float32;
// limbs 1 or 2; accumulate: add into c (else overwrite). a_vec / b_vec:
// the operand's base and row stride are 16-byte aligned (cp.async of whole
// chunks). Returns the cudaError_t of the launch.
int evc_limb_mm(int form, int limbs, const void* a0, const void* a1,
                const void* b, void* c, int M, int N, int K, long long lda,
                long long ldb, long long ldc, int a_vec, int b_vec,
                int accumulate, void* stream) {
  if (form < kGrad || form > kLogitsMK || (limbs != 1 && limbs != 2) ||
      M <= 0 || N <= 0 || K <= 0 || !a0 || !b || !c ||
      (form == kStored && limbs == 2 && !a1) ||
      reinterpret_cast<uintptr_t>(b) % 2 || reinterpret_cast<uintptr_t>(c) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  Args p = {};
  p.a[0] = a0;
  p.a[1] = a1;
  p.b = static_cast<const uint16_t*>(b);
  p.c = static_cast<float*>(c);
  p.M = M;
  p.N = N;
  p.K = K;
  p.lda = lda;
  p.ldb = ldb;
  p.ldc = ldc;
  p.a_vec = a_vec;
  p.b_vec = b_vec;
  p.accumulate = accumulate;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case kGrad:
      return static_cast<int>(launch_limbs<kGrad>(p, limbs, s));
    case kStored:
      return static_cast<int>(launch_limbs<kStored>(p, limbs, s));
    case kLogitsKM:
      return static_cast<int>(launch_limbs<kLogitsKM>(p, limbs, s));
    default:
      return static_cast<int>(launch_limbs<kLogitsMK>(p, limbs, s));
  }
}

// The warpgroups per block (1 or 2) that evc_limb_mm launches for an
// M x N output (its M and N) on the current device, into *out: with the
// form and limbs, the kernel instantiation it runs. Returns the
// cudaError_t of reading the device.
int evc_limb_mm_warpgroups(int M, int N, int* out) {
  int device = -1;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *out = warpgroups(M, N, device);
  return 0;
}

const char* evc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
