// Flash-attention forward for Hopper (sm_90a) on the tensor cores, plain C
// interface.
//
// Replaces the Pallas TPU kernel `_fa_kernel` of the reference package
// (parsec_tpu/ops/flash_attention.py:44-101, launched at :165). It computes
// the same function: softmax attention over (S, H, dh) operands with an
// online softmax kept in f32, an optional causal mask on global positions
// (qpos >= kpos, both from 0, also when Sk != S) that skips wholly-future
// KV tiles and keeps p = 0 on masked entries (finite -1e30 mask value), and
// the finalize o = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)).
//
// Precision. Like the reference, the kernel follows ops.matmul_precision,
// passed in as a number of TF32 passes. npass = 1 (`default`) rounds each
// operand to TF32 (cvt.rna) and multiplies once. npass = 3 (`high`,
// `highest`) is 3xTF32: x = big + small with big = tf32(x) and small =
// tf32(x - big), and a*b = a_small*b_big + a_big*b_small + a_big*b_big
// (small terms first), which keeps FP32-level accuracy on the tensor
// cores. bf16 inputs are exact in TF32 and carry no small part; P, made
// in f32 by the softmax, is split in 3-pass mode whatever the input type.
//
// Design.
// - One CTA owns (query block of 64 rows, key split, head): warpgroup 0
//   consumes, warpgroup 1 produces. The consumer runs S = Q K^T and
//   O += P V with `wgmma.mma_async ... m64nNk8.f32.tf32.tf32`; its S and O
//   accumulators stay in registers, Q's big part is held as A fragments in
//   registers, and P goes from the S accumulator straight into the A
//   registers of the second product.
// - Q, K and V^T sit in shared memory in the 128-byte swizzled K-major
//   layout wgmma reads through descriptors: atoms of 8 rows x 32 floats,
//   1024-byte aligned, the 16-byte chunk index XORed with the row (mod 8).
// - For .tf32 wgmma takes both operands K-major only (the transpose
//   flags exist for 16-bit types), and V is stored (keys, dh). So the
//   producer writes V^T. It also permutes the keys inside each group of
//   8 (key 2q -> position q, key 2q+1 -> position q+4): the S accumulator
//   holds columns {2t, 2t+1} of each group of 8 in lane quad t, and the
//   tf32 A fragment wants k positions {t, t+4}, so P needs no shuffle.
// - The producer keeps a ring of K / V^T tiles (2 stages in 3-pass f32,
//   4 otherwise), handed over with mbarriers (full: 128 producer
//   arrivals, empty: 128 consumer arrivals). It goes through registers:
//   every tile is rounded (and split) to TF32, bf16 is widened, and V is
//   transposed. Its generic-proxy stores are made visible to wgmma with
//   fence.proxy.async before the arrival. It loads the next tile before
//   it waits for a free stage; its offsets are computed once per thread.
// - The consumer pipelines over its tiles: the softmax of tile i runs
//   while O += P V of tile i-1 is on the tensor cores, and S of tile i+1
//   is issued right before P V of tile i.
// - Split-KV: when H * ceil(S/64) CTAs would leave SMs idle, the wrapper
//   asks for n_split > 1 CTAs per (head, query block). Split s covers the
//   keys [b(s), b(s+1)) with b(s) = floor(s*Sk/n_split) rounded down to a
//   multiple of 64 (b(n_split) = Sk), cut at the causal horizon of the
//   query block; a split wholly in the future runs no tile and writes
//   o = 0, lse = -1e30 + log(1e-30). Each split writes a partial (o, lse)
//   in f32 to scratch, and fa_combine_kernel merges them in a second pass
//   (blocks run in no order, so the cross-block reduction cannot live in
//   the first): M = max lse_j, w_j = exp(lse_j - M), o = sum w_j o_j /
//   sum w_j, lse = M + log(sum w_j); wholly masked splits are skipped.
//
// Shared memory per CTA (NP = 2 input parts in 3-pass f32, else 1): Q
// NP*64*DHP floats, ring STAGES * 2 (K, V^T) * NP * BK*DHP floats, 1 KB of
// alignment slack and the barriers. BK = 32 keys at dh <= 128 (one K+V
// tile is 64 registers a producer thread), 64 below. 3-pass f32 dh=128:
// 64 KB + 128 KB = 192 KB; 1-pass or bf16 dh=128: 32 KB + 128 KB = 160 KB;
// every other variant less. One CTA fits on an SM. The ptxas report
// (registers, spills) of every variant is printed by chip_smoke.py and
// recorded in PERF.md.
//
// Bound. Per head the kernel does 4*S*Sk*dh flops (about half under
// causal) and moves (S + 2*Sk)*dh inputs and S*dh + S outputs: it is
// bound by arithmetic. The tensor-core peak is 495 TFLOP/s in TF32, so
// the 3-pass mode's bound is 3x the flops at that rate. What holds it
// back (PERF.md): the producer's rounding, splitting and transposing
// stores, and the S product's shared-memory reads of Q's small part.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;             // query rows per CTA: one consumer warpgroup
constexpr int NTHREADS = 256;      // warpgroup 0 consumes, warpgroup 1 produces
constexpr int SPLIT_ALIGN = 64;    // split boundaries are multiples of this
constexpr float NEG = -1e30f;      // finite -inf (same convention as the TPU kernel)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <typename T, int DHP, int NPASS>
struct Cfg {
    static constexpr int NP = (sizeof(T) == 4 && NPASS == 3) ? 2 : 1;
    static constexpr int STAGES = NP == 2 ? 2 : 4;      // K/V ring depth that fits
    static constexpr int BK = DHP == 128 ? 32 : 64;    // one K+V tile fits in registers
    static constexpr int Q_FLOATS = BQ * DHP;          // one part of Q
    static constexpr int T_FLOATS = BK * DHP;          // one part of K or V^T
    static constexpr int STAGE_FLOATS = 2 * NP * T_FLOATS;
    static constexpr size_t SMEM = 1024 + sizeof(float) *
        (size_t)(NP * Q_FLOATS + STAGES * STAGE_FLOATS) + 2 * STAGES * sizeof(uint64_t);
};

__device__ __forceinline__ int split_start(int s, int Sk, int n_split)
{
    if (s >= n_split) return Sk;
    return (int)(((long long)s * Sk / n_split) / SPLIT_ALIGN * SPLIT_ALIGN);
}

// ---- PTX helpers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x rounded to TF32, to nearest with ties away from zero: what
// cvt.rna.tf32.f32 computes (also for inf and nan), in two integer
// operations instead of the four it compiles to
__device__ __forceinline__ float tf32(float x)
{
    return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

__device__ __forceinline__ void bar_init(uint64_t* b, int count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_u32(b)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* b)
{
    asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}"
                 :: "r"(smem_u32(b)) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* b, int parity)
{
    const uint32_t addr = smem_u32(b);
    uint32_t done = 0;
    while (!done) {
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}"
                     : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    }
}

__device__ __forceinline__ void fence_proxy_async()
{
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void consumer_sync()   // warpgroup 0 only
{
    asm volatile("bar.sync 1, 128;" ::: "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>   // until at most N committed groups are pending
__device__ __forceinline__ void wg_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory"); }

// keep the compiler from touching wgmma operands before wg_wait()
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N])
{
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N])
{
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (SBO); LBO is unused for swizzled K-major layouts.
__device__ __forceinline__ uint64_t make_desc(const float* p)
{
    const uint32_t a = smem_u32(p);
    return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
           ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
// descriptor of the same layout `bytes` further on (start address field)
__device__ __forceinline__ uint64_t desc_add(uint64_t d, int bytes)
{
    return d + (uint64_t)(bytes >> 4);
}

#define WG_D16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WG_D32 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_D64 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
               "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
               "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define WG_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_F16(d, i) WG_F4(d, i), WG_F4(d, i + 4), WG_F4(d, i + 8), WG_F4(d, i + 12)
#define WG_F32(d, i) WG_F16(d, i), WG_F16(d, i + 16)
#define WG_F64(d) WG_F32(d, 0), WG_F32(d, 32)

// D (64 x N, f32) = or += A (64 x 8, tf32, shared) * B (8 x N, tf32, shared)
template <int N> struct Wg;

template <> struct Wg<32> {
    __device__ static __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b, int acc)
    {
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
                     "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
                     WG_D16 ", %16, %17, p, 1, 1;\n}"
                     : WG_F16(d, 0) : "l"(a), "l"(b), "r"(acc));
    }
    __device__ static __forceinline__ void rs(float (&d)[16], const uint32_t* a, uint64_t b)
    {
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
                     "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
                     WG_D16 ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}"
                     : WG_F16(d, 0)
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    }
};

template <> struct Wg<64> {
    __device__ static __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int acc)
    {
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                     "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
                     WG_D32 ", %32, %33, p, 1, 1;\n}"
                     : WG_F32(d, 0) : "l"(a), "l"(b), "r"(acc));
    }
    __device__ static __forceinline__ void rs(float (&d)[32], const uint32_t* a, uint64_t b)
    {
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                     "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
                     WG_D32 ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}"
                     : WG_F32(d, 0)
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    }
};

template <> struct Wg<128> {
    __device__ static __forceinline__ void rs(float (&d)[64], const uint32_t* a, uint64_t b)
    {
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                     "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
                     WG_D64 ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}"
                     : WG_F64(d)
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    }
};

// ---- staging: global -> registers -> swizzled shared ----------------------

// float offset of (row, col) in a K-major tile of `rows` rows laid out as
// [col / 32][rows][32] with the 128-byte swizzle
__device__ __forceinline__ int swz(int row, int col, int rows)
{
    return (col >> 5) * rows * 32 + row * 32 + ((((col >> 2) & 7) ^ (row & 7)) << 2) + (col & 3);
}

// V^T column of key r in its tile: inside each group of 8, key 2q goes to
// position q and key 2q+1 to position q+4 (see the note at the top)
__device__ __forceinline__ int key_pos(int r)
{
    const int w = r & 7;
    return (r & ~7) | ((w & 1) << 2) | (w >> 1);
}

__device__ __forceinline__ float4 load4(const float* p, int d, int dh, bool vec)
{
    if (vec) return *reinterpret_cast<const float4*>(p);
    float4 x;
    x.x = p[0];
    x.y = d + 1 < dh ? p[1] : 0.f;
    x.z = d + 2 < dh ? p[2] : 0.f;
    x.w = d + 3 < dh ? p[3] : 0.f;
    return x;
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, int d, int dh, bool vec)
{
    float4 x;
    if (vec) {
        const uint2 u = *reinterpret_cast<const uint2*>(p);
        const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
        const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
        x.x = __low2float(lo); x.y = __high2float(lo);
        x.z = __low2float(hi); x.w = __high2float(hi);
        return x;
    }
    x.x = __bfloat162float(p[0]);
    x.y = d + 1 < dh ? __bfloat162float(p[1]) : 0.f;
    x.z = d + 2 < dh ? __bfloat162float(p[2]) : 0.f;
    x.w = d + 3 < dh ? __bfloat162float(p[3]) : 0.f;
    return x;
}

__device__ __forceinline__ float4 tf32x4(float4 x)
{
    return make_float4(tf32(x.x), tf32(x.y), tf32(x.z), tf32(x.w));
}

__device__ __forceinline__ float4 sub4(float4 a, float4 b)
{
    return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

__device__ __forceinline__ void sts(uint32_t addr, float x)
{
    asm volatile("st.shared.f32 [%0], %1;" :: "r"(addr), "f"(x) : "memory");
}

__device__ __forceinline__ void sts4(uint32_t addr, float4 x)
{
    asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};"
                 :: "r"(addr), "f"(x.x), "f"(x.y), "f"(x.z), "f"(x.w) : "memory");
}

// Moves tiles of ROWS rows x DHP columns of one head of a (rows, H, dh)
// tensor global -> registers (load) -> shared (store), rounded to TF32
// into NP parts (big, then small; each ROWS*DHP floats): K-major as
// stored (TRANS = false), or transposed with permuted keys (TRANS = true,
// for V). 128 threads; one warp covers 8 rows x 16 columns, so global
// reads use whole sectors and the swizzled stores are free of bank
// conflicts (2-way for V^T). Every offset is fixed per thread and
// computed once; tiles differ only in their first row.
template <typename T, int ROWS, int DHP, int NP, bool TRANS>
struct Stager {
    static constexpr int IT = ROWS * DHP / 4 / 128;   // float4 per thread
    static_assert(IT >= 1 && ROWS * DHP / 4 % 128 == 0, "tile too small for 128 threads");
    int tid, dh, rs;
    bool vec;
    int goff[IT];                       // from the tile's first row, in elements
    uint32_t soff[IT][TRANS ? 4 : 1];   // bytes into a part of the shared tile

    __device__ __forceinline__ void coords(int it, int& r, int& d) const
    {
        const int idx = tid + it * 128;
        const int blk = idx >> 5;
        r = (blk / (DHP / 16)) * 8 + (idx & 7);
        d = (blk % (DHP / 16)) * 16 + ((idx >> 3) & 3) * 4;
    }

    __device__ __forceinline__ Stager(int tid_, int h, int H, int dh_, bool vec_)
        : tid(tid_), dh(dh_), rs(H * dh_), vec(vec_)
    {
#pragma unroll
        for (int it = 0; it < IT; ++it) {
            int r, d;
            coords(it, r, d);
            goff[it] = r * rs + h * dh + d;
            if constexpr (!TRANS) {
                soff[it][0] = 4 * swz(r, d, ROWS);
            } else {
#pragma unroll
                for (int e = 0; e < 4; ++e) soff[it][e] = 4 * swz(d + e, key_pos(r), DHP);
            }
        }
    }

    // rows [row0, row0 + ROWS) of `src`, zero at rows >= nrows and
    // columns >= dh
    __device__ __forceinline__ void load(float4 (&buf)[IT], const T* __restrict__ src,
                                         int row0, int nrows) const
    {
        const T* base = src + (long)row0 * rs;
        if (vec && row0 + ROWS <= nrows) {   // whole tile in range
#pragma unroll
            for (int it = 0; it < IT; ++it) {
                int r, d;
                coords(it, r, d);
                buf[it] = d < dh ? load4(base + goff[it], d, dh, true)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
            }
        } else {
#pragma unroll
            for (int it = 0; it < IT; ++it) {
                int r, d;
                coords(it, r, d);
                buf[it] = (row0 + r < nrows && d < dh) ? load4(base + goff[it], d, dh, vec)
                                                       : make_float4(0.f, 0.f, 0.f, 0.f);
            }
        }
    }

    __device__ __forceinline__ void store(const float4 (&buf)[IT], const float* dst) const
    {
        const uint32_t base = smem_u32(dst);
#pragma unroll
        for (int it = 0; it < IT; ++it) {
            const float4 big = tf32x4(buf[it]);
            const float4 small = tf32x4(sub4(buf[it], big));
#pragma unroll
            for (int part = 0; part < NP; ++part) {
                const float4 x = part == 0 ? big : small;
                const uint32_t pbase = base + part * ROWS * DHP * 4;
                if constexpr (!TRANS) {
                    sts4(pbase + soff[it][0], x);
                } else {
                    sts(pbase + soff[it][0], x.x);
                    sts(pbase + soff[it][1], x.y);
                    sts(pbase + soff[it][2], x.z);
                    sts(pbase + soff[it][3], x.w);
                }
            }
        }
    }
};

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// ---- attention ------------------------------------------------------------

template <typename T, int DHP, int NPASS>
__global__ void __launch_bounds__(NTHREADS, 1)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ o, float* __restrict__ lse, float* __restrict__ part,
              int S, int Sk, int H, int dh, float scale, int causal, int n_split, int vec)
{
    using C = Cfg<T, DHP, NPASS>;
    constexpr int NP = C::NP, BK = C::BK;
    extern __shared__ unsigned char smem_raw[];
    // swizzle atoms must be 1024-byte aligned
    const uint32_t raw = smem_u32(smem_raw);
    float* sQ = reinterpret_cast<float*>(smem_raw + ((1024 - (raw & 1023)) & 1023));
    float* sRing = sQ + NP * C::Q_FLOATS;
    uint64_t* full = reinterpret_cast<uint64_t*>(sRing + C::STAGES * C::STAGE_FLOATS);
    uint64_t* empty = full + C::STAGES;

    const int q0 = blockIdx.x * BQ;
    const int split = blockIdx.y;
    const int h = blockIdx.z;
    const long rs = (long)H * dh;      // row stride of (S, H, dh)
    // this split's keys, cut at the causal horizon of the query block
    const int k_lo = split_start(split, Sk, n_split);
    int k_hi = split_start(split + 1, Sk, n_split);
    if (causal) k_hi = min(k_hi, q0 + BQ);
    const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

    if (threadIdx.x == 0) {
        for (int s = 0; s < C::STAGES; ++s) {
            bar_init(&full[s], 128);
            bar_init(&empty[s], 128);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x >= 128) {
        // producer warpgroup: keep the K / V^T ring filled. The next
        // tile's loads are in flight while it waits for a free stage.
        using KS = Stager<T, BK, DHP, NP, false>;
        using VS = Stager<T, BK, DHP, NP, true>;
        const KS ks(threadIdx.x - 128, h, H, dh, vec);
        const VS vs(threadIdx.x - 128, h, H, dh, vec);
        float4 kbuf[KS::IT], vbuf[VS::IT];
        if (n_tiles > 0) {
            ks.load(kbuf, k, k_lo, Sk);
            vs.load(vbuf, v, k_lo, Sk);
        }
        for (int i = 0; i < n_tiles; ++i) {
            const int st = i % C::STAGES;
            bar_wait(&empty[st], ((i / C::STAGES) & 1) ^ 1);
            const float* sK = sRing + st * C::STAGE_FLOATS;
            ks.store(kbuf, sK);
            vs.store(vbuf, sK + NP * C::T_FLOATS);
            fence_proxy_async();
            bar_arrive(&full[st]);
            if (i + 1 < n_tiles) {
                ks.load(kbuf, k, k_lo + (i + 1) * BK, Sk);
                vs.load(vbuf, v, k_lo + (i + 1) * BK, Sk);
            }
        }
        return;
    }

    // consumer warpgroup: rows row and row + 8 of the query block, key
    // columns {2t, 2t+1} of each group of 8 (the wgmma accumulator layout)
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int t = lane & 3;
    const int row = (tid >> 5) * 16 + (lane >> 2);
    const int qpos[2] = {q0 + row, q0 + row + 8};

    if (n_tiles > 0) {
        using QS = Stager<T, BQ, DHP, NP, false>;
        const QS qs(tid, h, H, dh, vec);
        float4 qbuf[QS::IT];
        qs.load(qbuf, q, q0, S);
        qs.store(qbuf, sQ);
        fence_proxy_async();
        consumer_sync();
    }

    const uint64_t dQ = make_desc(sQ);
    // Q's big part as tf32 A fragments, one set of 4 per step of 8 in dh:
    // {(row, t), (row+8, t), (row, t+4), (row+8, t+4)}; the scores read Q
    // from registers and only Q's small part from shared memory
    uint32_t qa[DHP / 8][4];
    if (n_tiles > 0) {
#pragma unroll
        for (int ks = 0; ks < DHP / 8; ++ks) {
            const int c = ks * 8 + t;
            qa[ks][0] = __float_as_uint(sQ[swz(row, c, BQ)]);
            qa[ks][1] = __float_as_uint(sQ[swz(row + 8, c, BQ)]);
            qa[ks][2] = __float_as_uint(sQ[swz(row, c + 4, BQ)]);
            qa[ks][3] = __float_as_uint(sQ[swz(row + 8, c + 4, BQ)]);
        }
    }
    const float sl2 = scale * LOG2E;   // scores in log2 units: exp2 below
    float acc[DHP / 2];
#pragma unroll
    for (int i = 0; i < DHP / 2; ++i) acc[i] = 0.f;
    float m[2] = {NEG, NEG};
    float l[2] = {0.f, 0.f};           // this thread's share of the row sums

    // S = Q K^T of tile i over dh in steps of 8, issued and committed
    float s[BK / 2];
    auto issue_scores = [&](int i) {
        const int st = i % C::STAGES;
        bar_wait(&full[st], (i / C::STAGES) & 1);
        const uint64_t dK = make_desc(sRing + st * C::STAGE_FLOATS);
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) s[j] = 0.f;
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < DHP / 8; ++ks) {
            const uint64_t db = desc_add(dK, ((ks >> 2) * BK * 32 + (ks & 3) * 8) * 4);
            if constexpr (NP == 2) {
                const uint64_t da = desc_add(dQ, C::Q_FLOATS * 4 +
                                             ((ks >> 2) * BQ * 32 + (ks & 3) * 8) * 4);
                Wg<BK>::ss(s, da, db, 1);                                  // Qs Kb
                Wg<BK>::rs(s, qa[ks], desc_add(db, C::T_FLOATS * 4));      // Qb Ks
            }
            Wg<BK>::rs(s, qa[ks], db);                                     // Qb Kb
        }
        wg_commit();
    };

    // O += P V^T of tile i over its keys in steps of 8, issued and committed
    uint32_t pb[BK / 2];
    uint32_t ps[NPASS == 3 ? BK / 2 : 1];
    auto issue_pv = [&](int i) {
        const uint64_t dV = make_desc(sRing + (i % C::STAGES) * C::STAGE_FLOATS + NP * C::T_FLOATS);
        wg_fence();
#pragma unroll
        for (int c = 0; c < BK / 8; ++c) {
            const uint64_t db = desc_add(dV, ((c >> 2) * DHP * 32 + (c & 3) * 8) * 4);
            if constexpr (NPASS == 3) Wg<DHP>::rs(acc, &ps[4 * c], db);
            if constexpr (NP == 2) Wg<DHP>::rs(acc, &pb[4 * c], desc_add(db, C::T_FLOATS * 4));
            Wg<DHP>::rs(acc, &pb[4 * c], db);
        }
        wg_commit();
    };

    // Software pipeline over the tiles: the softmax of tile i runs while
    // O += P V of tile i-1 is on the tensor cores; S of tile i+1 is issued
    // right before P V of tile i.
    if (n_tiles > 0) {
        issue_scores(0);
        wg_wait<0>();
        reg_fence(s);
    }
    for (int i = 0; i < n_tiles; ++i) {
        // mask, scale, online softmax (rows reduced over the lane quad)
        const int kbase = k_lo + i * BK;
        float mx[2] = {NEG, NEG};
#pragma unroll
        for (int c = 0; c < BK / 8; ++c) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int kpos = kbase + c * 8 + 2 * t + e;
#pragma unroll
                for (int rr = 0; rr < 2; ++rr) {
                    float x = s[4 * c + 2 * rr + e] * sl2;
                    if (kpos >= Sk || (causal && qpos[rr] < kpos)) x = NEG;
                    s[4 * c + 2 * rr + e] = x;
                    mx[rr] = fmaxf(mx[rr], x);
                }
            }
        }
        float corr[2];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
            mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
            mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
            const float m_new = fmaxf(m[rr], mx[rr]);
            corr[rr] = exp2f(m[rr] - m_new);
            m[rr] = m_new;
        }
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int c = 0; c < BK / 8; ++c) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int rr = j >> 1;
                const float x = s[4 * c + j];
                // masked entries keep p exactly zero (rows masked so far
                // have m == NEG, where exp2 would give 1)
                const float p = x > 0.5f * NEG ? exp2f(x - m[rr]) : 0.f;
                s[4 * c + j] = p;
                sum[rr] += p;
            }
        }
        l[0] = l[0] * corr[0] + sum[0];
        l[1] = l[1] * corr[1] + sum[1];

        // P V of tile i-1 is done: acc and the P registers are free, and
        // its stage goes back to the producer
        wg_wait<0>();
        reg_fence(acc);
        reg_fence(pb);
        reg_fence(ps);
        if (i > 0) bar_arrive(&empty[(i - 1) % C::STAGES]);
#pragma unroll
        for (int j = 0; j < DHP / 8; ++j) {
            acc[4 * j] *= corr[0];
            acc[4 * j + 1] *= corr[0];
            acc[4 * j + 2] *= corr[1];
            acc[4 * j + 3] *= corr[1];
        }

        // P as tf32 A fragments: chunk c -> {(row, 2t), (row+8, 2t),
        // (row, 2t+1), (row+8, 2t+1)} = k positions {t, t, t+4, t+4}
#pragma unroll
        for (int c = 0; c < BK / 8; ++c) {
            const float a4[4] = {s[4 * c], s[4 * c + 2], s[4 * c + 1], s[4 * c + 3]};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float big = tf32(a4[j]);
                pb[4 * c + j] = __float_as_uint(big);
                if constexpr (NPASS == 3) ps[4 * c + j] = __float_as_uint(tf32(a4[j] - big));
            }
        }

        // one path per case, so that ptxas sees every read of s after
        // the wait that covers it (else it serializes the wgmmas)
        if (i + 1 < n_tiles) {
            issue_scores(i + 1);
            issue_pv(i);
            wg_wait<1>();        // scores of tile i+1 done, P V of tile i runs on
            reg_fence(s);
        } else {
            issue_pv(i);
        }
    }
    wg_wait<0>();
    reg_fence(acc);
    reg_fence(pb);
    reg_fence(ps);

    // finalize: o = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30))
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
        float lt = l[rr];
        lt += __shfl_xor_sync(0xffffffffu, lt, 1);
        lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        const float lc = fmaxf(lt, 1e-30f);
        const float inv = 1.f / lc;
        const float row_lse = (m[rr] > 0.5f * NEG ? m[rr] * LN2 : NEG) + logf(lc);
        const int qp = qpos[rr];
        if (qp >= S) continue;
        if (n_split == 1) {
            T* orow = o + (long)qp * rs + (long)h * dh;
#pragma unroll
            for (int j = 0; j < DHP / 8; ++j) {
                const int d = 8 * j + 2 * t;
                if (d < dh) store_out(orow + d, acc[4 * j + 2 * rr] * inv);
                if (d + 1 < dh) store_out(orow + d + 1, acc[4 * j + 2 * rr + 1] * inv);
            }
            if (t == 0) lse[(long)qp * H + h] = row_lse;
        } else {
            const long prow = (long)split * S * H + (long)qp * H + h;
            float* orow = part + prow * dh;
#pragma unroll
            for (int j = 0; j < DHP / 8; ++j) {
                const int d = 8 * j + 2 * t;
                if (d < dh) orow[d] = acc[4 * j + 2 * rr] * inv;
                if (d + 1 < dh) orow[d + 1] = acc[4 * j + 2 * rr + 1] * inv;
            }
            if (t == 0) part[(long)n_split * S * H * dh + prow] = row_lse;
        }
    }
}

// ---- combine: merge the splits' partial (o, lse) --------------------------

template <typename T>
__global__ void __launch_bounds__(256)
fa_combine_kernel(const float* __restrict__ o_part, const float* __restrict__ lse_part,
                  T* __restrict__ o, float* __restrict__ lse, long rows, int dh, int n_split)
{
    const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= rows * dh) return;
    const long r = idx / dh;
    const int d = (int)(idx - r * dh);
    float M = NEG;
    for (int j = 0; j < n_split; ++j) M = fmaxf(M, lse_part[j * rows + r]);
    float den = 0.f, num = 0.f;
    for (int j = 0; j < n_split; ++j) {
        const float lj = lse_part[j * rows + r];
        if (lj <= 0.5f * NEG) continue;   // wholly masked split: weight 0
        const float w = expf(lj - M);
        den += w;
        num += w * o_part[(j * rows + r) * dh + d];
    }
    den = fmaxf(den, 1e-30f);
    store_out(o + idx, num / den);
    if (d == 0) lse[r] = M + logf(den);
}

// ---- launchers ------------------------------------------------------------

template <typename T, int DHP, int NPASS>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                       void* scratch, int S, int Sk, int H, int dh, float scale,
                       int causal, int n_split, int vec, cudaStream_t stream)
{
    using C = Cfg<T, DHP, NPASS>;
    const cudaError_t err = cudaFuncSetAttribute(
        fa_fwd_kernel<T, DHP, NPASS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)C::SMEM);
    if (err != cudaSuccess) return err;
    const dim3 grid((S + BQ - 1) / BQ, n_split, H);
    fa_fwd_kernel<T, DHP, NPASS><<<grid, NTHREADS, C::SMEM, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), static_cast<float*>(lse), static_cast<float*>(scratch),
        S, Sk, H, dh, scale, causal, n_split, vec);
    return cudaGetLastError();
}

template <typename T, int NPASS>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v, void* o, void* lse,
                        void* scratch, int S, int Sk, int H, int dh, float scale,
                        int causal, int n_split, int vec, cudaStream_t st)
{
    if (dh <= 32)
        return launch_fwd<T, 32, NPASS>(q, k, v, o, lse, scratch, S, Sk, H, dh, scale, causal, n_split, vec, st);
    if (dh <= 64)
        return launch_fwd<T, 64, NPASS>(q, k, v, o, lse, scratch, S, Sk, H, dh, scale, causal, n_split, vec, st);
    return launch_fwd<T, 128, NPASS>(q, k, v, o, lse, scratch, S, Sk, H, dh, scale, causal, n_split, vec, st);
}

template <typename T>
cudaError_t dispatch_pass(const void* q, const void* k, const void* v, void* o, void* lse,
                          void* scratch, int S, int Sk, int H, int dh, float scale,
                          int causal, int npass, int n_split, int vec, cudaStream_t st)
{
    if (npass == 1)
        return dispatch_dh<T, 1>(q, k, v, o, lse, scratch, S, Sk, H, dh, scale, causal, n_split, vec, st);
    return dispatch_dh<T, 3>(q, k, v, o, lse, scratch, S, Sk, H, dh, scale, causal, n_split, vec, st);
}

}  // namespace

extern "C" {

// q (S, H, dh), k and v (Sk, H, dh) in the input type, all contiguous on
// the current device. dtype: 0 = float32, 1 = bfloat16; npass: 1 (TF32)
// or 3 (3xTF32). n_split == 1: writes o (S, H, dh) in the input type and
// lse (S, H) f32. n_split > 1: writes the splits' partial o (n_split, S,
// H, dh) and lse (n_split, S, H), f32, one after the other into scratch,
// for fa_combine. Returns a cudaError_t (0 = launched).
int fa_fwd(const void* q, const void* k, const void* v, void* o, void* lse, void* scratch,
           int S, int Sk, int H, int dh, float scale, int causal, int dtype, int npass,
           int n_split, void* stream)
{
    if (S <= 0 || Sk <= 0 || H <= 0 || dh <= 0 || dh > 128 || H > 65535 ||
        n_split < 1 || n_split > 65535 || (npass != 1 && npass != 3) ||
        (n_split > 1 && scratch == nullptr))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uintptr_t ptrs = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
    if (dtype == 0) {
        const int vec = dh % 4 == 0 && ptrs % 16 == 0;
        return (int)dispatch_pass<float>(q, k, v, o, lse, scratch, S, Sk, H, dh, scale,
                                         causal, npass, n_split, vec, st);
    }
    if (dtype == 1) {
        const int vec = dh % 4 == 0 && ptrs % 8 == 0;
        return (int)dispatch_pass<__nv_bfloat16>(q, k, v, o, lse, scratch, S, Sk, H, dh,
                                                 scale, causal, npass, n_split, vec, st);
    }
    return (int)cudaErrorInvalidValue;
}

// o_part (n_split, rows, dh) and lse_part (n_split, rows), f32; o (rows,
// dh) in the output type (dtype as above), lse (rows) f32.
int fa_combine(const void* o_part, const void* lse_part, void* o, void* lse, long rows,
               int dh, int n_split, int dtype, void* stream)
{
    if (rows <= 0 || dh <= 0 || n_split < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const long n = rows * dh;
    const unsigned blocks = (unsigned)((n + 255) / 256);
    const float* op = static_cast<const float*>(o_part);
    const float* lp = static_cast<const float*>(lse_part);
    if (dtype == 0)
        fa_combine_kernel<float><<<blocks, 256, 0, st>>>(
            op, lp, static_cast<float*>(o), static_cast<float*>(lse), rows, dh, n_split);
    else if (dtype == 1)
        fa_combine_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
            op, lp, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), rows, dh, n_split);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

const char* fa_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
